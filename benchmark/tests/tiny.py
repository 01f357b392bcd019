"""A cell at a size the CPU tests hold: the configuration's widths cut
to 160x120, a small scene and two envs.  Tests only: no run of the
benchmark takes this size."""

from __future__ import annotations

import copy

from benchmark import harness as H


def tiny_cell(name: str = "fr3_align_loop.e64", num_envs: int = 2,
              envs: int = 1, steps: int = 2) -> H.Cell:
    cell = H.find_cell(name)
    config = copy.deepcopy(cell.config)
    config["raster"].update(width=160, height=120, max_entries=16384)
    config["synthetic_sizes"] = {"n_background": 2400, "n_per_link": 120,
                                 "n_per_object": 120}
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(num_envs=num_envs, warmup_steps=1, trace_steps=2)
    traffic["check"].update(envs=envs, steps=steps)
    return H.Cell(name=cell.name, entry=cell.entry,
                  config_entry=cell.config_entry, config=config,
                  traffic=traffic, end_to_end=cell.end_to_end,
                  per_layer=cell.per_layer)


def tiny_train_cell() -> H.Cell:
    cell = H.find_cell("fr3_align_3dgs.train")
    config = copy.deepcopy(cell.config)
    config["raster"].update(width=64, height=48, max_entries=16384)
    config["synthetic_sizes"] = {"n_background": 1200, "n_per_link": 40,
                                 "n_per_object": 40}
    # the schedule compressed: the first densify pass at 4, the opacity
    # reset (and a densify pass) at 8
    config["optimization"].update(densify_from_iter=4,
                                  densification_interval=2,
                                  opacity_reset_interval=8)
    traffic = copy.deepcopy(cell.traffic)
    traffic["trace_iters"] = 2
    return H.Cell(name=cell.name, entry=cell.entry,
                  config_entry=cell.config_entry, config=config,
                  traffic=traffic, end_to_end=cell.end_to_end,
                  per_layer=cell.per_layer)
