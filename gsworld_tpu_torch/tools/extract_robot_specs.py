#!/usr/bin/env python3
"""Extract compact robot specs from URDF + mesh source trees (port of
tools/extract_robot_specs.py).

Reads each robot's description (URDF XML and its collision STL meshes),
reduces every collision mesh to a convex support point set, samples
per-link surface points, and writes ``<name>.json`` + ``<name>_geom.npz``
as ``physics.spec_io.load_robot_spec`` reads them:

    python3 gsworld_tpu_torch/tools/extract_robot_specs.py \\
        --src DIR_WITH_ROBOT_DESCRIPTIONS --out OUT_DIR

Host numpy only.  The shipped specs under ``gsworld_tpu/assets/robots/``
were made this way from the GSWorld robot descriptions (``ROBOTS`` gives
each URDF's path under ``--src``); a robot whose URDF is missing is
skipped with a line that says so.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gsworld_tpu_torch.physics import meshes  # noqa: E402
from gsworld_tpu_torch.physics.spec_io import (  # noqa: E402
    GeomSpec,
    save_robot_spec,
)
from gsworld_tpu_torch.physics.urdf import parse_urdf  # noqa: E402

_PANDA = "gsworld/mani_skill/assets/robots/panda/"
_XARM = "gsworld/mani_skill/assets/robots/xarm6/xarm6_description/"
ROBOTS = {
    # name -> URDF path relative to --src
    "fr3_umi": _PANDA + "fr3_umi.urdf",
    "fr3_umi_wrist435": _PANDA + "fr3_umi_wrist435.urdf",
    "fr3_umi_wrist435_cam_mount": _PANDA + "fr3_umi_wrist435_w_mount.urdf",
    "xarm6_uf_gripper": _XARM + "xarm6_uf_gripper.urdf",
    "xarm6_uf_gripper_wrist435": _XARM + "xarm6_uf_gripper_w_tcp_d435.urdf",
}

MAX_SUPPORT = 48
SURFACE_PTS = 2048


def reduce_link_collisions(link, max_support=MAX_SUPPORT):
    """Replace the link's mesh collision geoms by convex support point
    sets in the link frame (primitives stay) -> the link's surface
    samples (K, 3) f32, or None for a link without collisions."""
    new_cols, surf_parts = [], []
    for g in link.collisions:
        if g.kind == "mesh":
            if not os.path.exists(g.mesh_path):
                print(f"  WARN missing mesh {g.mesh_path}; skipping")
                continue
            verts, faces = meshes.load_stl(g.mesh_path)
            scale = g.mesh_scale if g.mesh_scale is not None else np.ones(3)
            verts_link = (verts * scale) @ g.origin_rot.T + g.origin_pos
            pts = meshes.convex_support_points(verts_link, max_support)
            new_cols.append(GeomSpec("points", np.zeros(3), np.eye(3),
                                     points=pts.astype(np.float32)))
            surf_parts.append(meshes.sample_surface(
                verts_link, faces,
                SURFACE_PTS // max(1, len(link.collisions))))
        else:
            new_cols.append(g)
            pts = meshes.primitive_points(g.kind, g.size)
            surf_parts.append(pts @ g.origin_rot.T + g.origin_pos)
    link.collisions = new_cols
    if surf_parts:
        return np.concatenate(surf_parts).astype(np.float32)
    return None


def extract(urdf_path: str, name: str, out_dir: str):
    """Parse one URDF, reduce its collisions and write its spec."""
    spec = parse_urdf(urdf_path)
    spec.name = name
    surface = {}
    for link in spec.links:
        surf = reduce_link_collisions(link)
        if surf is not None:
            surface[link.name] = surf
        nc = sum(g.points.shape[0] if g.points is not None else 1
                 for g in link.collisions)
        print(f"  {link.name:28s} mass={link.mass:7.3f} support_pts={nc}")
    save_robot_spec(spec, out_dir, surface)
    return spec, surface


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the robot descriptions")
    ap.add_argument("--out", required=True,
                    help="directory to write the specs into")
    args = ap.parse_args(argv)
    for name, rel in ROBOTS.items():
        path = os.path.join(args.src, rel)
        if not os.path.exists(path):
            print(f"SKIP {name}: {path} not found")
            continue
        print(f"== {name}")
        extract(path, name, args.out)
        print(f"  -> {args.out}/{name}.json (+_geom.npz)")


if __name__ == "__main__":
    main()
