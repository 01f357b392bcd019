"""Joint-space RRT-Connect with collision checking (port of
gsworld_tpu/rollout/planner/rrt.py).

The tree search runs on the host (tiny, branchy).  Collision queries are
one batched torch function on the env's device: forward kinematics of M
configurations, every contact link's support points placed in the world,
and every (link, actor) pair's points tested against the actor's hull
and the tabletop plane at once, so an edge check tests all of its
interpolated configurations in one call.  On a CUDA env built with
``graph=True`` that call replays one CUDA graph per batch size, as the
JAX package compiles its jitted check once per shape.
"""

from __future__ import annotations

import numpy as np
import torch

from gsworld_tpu_torch.utils.cuda_graph import FnGraph


def make_collision_checker(env, clearance: float = 0.002):
    """Returns check(qpos_batch (M, dof), a_pos (A, 3), a_quat (A, 4),
    root_pos (3,), root_quat (4,)) -> (M,) bool tensor (True = in
    collision).  Collision = any contact-link support point penetrating
    any actor hull by more than ``clearance``, or a contact link's point
    below the tabletop plane (the first of the scene's planes, unbounded)
    by more than ``clearance``.

    On a graphed CUDA env (``env._graphed()`` at the call) a call replays
    one CUDA graph per batch size M (an ``FnGraph``, captured at the first
    call with that M; ``check.graphs`` holds them by M): the batch is
    copied into the graph's static (M, dof) input and the (M,) output is
    a tensor of its own.  Otherwise it runs eagerly."""
    from gsworld_tpu_torch.physics import contact as C
    from gsworld_tpu_torch.physics.kinematics import forward_kinematics

    scene = env.scene
    model = env.agent.model
    dev = env.device
    f32 = dict(dtype=torch.float32, device=dev)
    la = np.asarray(scene.la_pairs).reshape(-1, 2)
    links = sorted(set(int(l) for l, _ in la))
    pair_link = torch.as_tensor(la[:, 0], dtype=torch.long, device=dev)
    pair_actor = torch.as_tensor(la[:, 1], dtype=torch.long, device=dev)
    plane_links = torch.as_tensor(links, dtype=torch.long, device=dev)
    pts_body = torch.as_tensor(np.asarray(scene.link_collision_pts), **f32)
    faces = torch.as_tensor(np.asarray(scene.actors.faces), **f32)[pair_actor]
    plane = torch.as_tensor(np.asarray(scene.planes)[0, :4], **f32)

    @torch.no_grad()
    def collides(q, a_pos, a_quat, root_pos, root_quat):
        M = q.shape[0]
        lp, lq = forward_kinematics(model, q, root_pos.expand(M, 3),
                                    root_quat.expand(M, 4))
        pts = C.transform_points(lp, lq, pts_body)           # (M, L, K, 3)
        pen, _, _ = C.points_vs_hull(
            pts[:, pair_link], a_pos[pair_actor], a_quat[pair_actor],
            faces)                                           # (M, P, K)
        hit = (pen > clearance).flatten(1).any(dim=1)
        # contact links below the tabletop plane
        h = pts[:, plane_links] @ plane[:3] + plane[3]       # (M, n, K)
        return hit | (h < -clearance).flatten(1).any(dim=1)

    graphs = {}

    def check(qpos_batch, a_pos, a_quat, root_pos, root_quat):
        q = torch.as_tensor(qpos_batch, dtype=torch.float32)
        args = (a_pos, a_quat, root_pos, root_quat)
        if not env._graphed():
            return collides(q.to(dev), *args)
        M = q.shape[0]
        if M not in graphs:
            graphs[M] = FnGraph(collides, dev, (q.to(dev), *args),
                                "the collision check",
                                pool=env.graph_pool())
        return graphs[M](q, *args)

    check.graphs = graphs
    return check


def _edge_free(check, q0, q1, args, resolution=0.05):
    n = max(2, int(np.ceil(np.abs(q1 - q0).max() / resolution)) + 1)
    qs = q0[None] + (q1 - q0)[None] * np.linspace(0, 1, n)[:, None]
    return not bool(check(qs, *args).any()), qs


def rrt_connect(env, q_start: np.ndarray, q_goal: np.ndarray,
                active_dofs, max_iters: int = 200, step: float = 0.3,
                resolution: float = 0.05, seed: int = 0,
                shortcut_iters: int = 30):
    """Plan a collision-free joint path (full-dof waypoints) for env 0.

    Returns (T, dof) waypoints or None.  Bidirectional RRT with a straight
    line tried first, then straight-line connect attempts, shortcut
    smoothing and densifying to ``resolution``; the samples come from
    numpy's ``default_rng(seed)``, so on the same checker answers the path
    is the JAX package's."""
    check = make_collision_checker(env)
    w = env.state.world
    args = (w.a_pos[0], w.a_quat[0], w.root_pos[0], w.root_quat[0])
    act = np.asarray(active_dofs)
    lo = env.agent.model.qlimits[act, 0]
    hi = env.agent.model.qlimits[act, 1]
    rng = np.random.default_rng(seed)

    def full(qa):
        q = np.array(q_start)
        q[act] = qa
        return q

    qa0 = q_start[act].astype(np.float64)
    qa1 = q_goal[act].astype(np.float64)
    if bool(check(full(qa1)[None], *args)[0]):
        return None                       # goal in collision

    # trivial straight line first (the common tabletop case)
    free, qs = _edge_free(check, full(qa0), full(qa1), args, resolution)
    if free:
        path = [qa0, qa1]
    else:
        trees = [[qa0], [qa1]]
        parents = [[-1], [-1]]
        path = None
        for it in range(max_iters):
            q_rand = rng.uniform(lo, hi)
            ta, tb = (0, 1) if it % 2 == 0 else (1, 0)
            # extend tree A toward q_rand
            da = [np.linalg.norm(q - q_rand) for q in trees[ta]]
            ia = int(np.argmin(da))
            q_near = trees[ta][ia]
            d = q_rand - q_near
            q_new = q_near + d * min(1.0, step / max(np.linalg.norm(d), 1e-9))
            ok, _ = _edge_free(check, full(q_near), full(q_new), args,
                               resolution)
            if not ok:
                continue
            trees[ta].append(q_new)
            parents[ta].append(ia)
            # try to connect tree B to q_new
            db = [np.linalg.norm(q - q_new) for q in trees[tb]]
            ib = int(np.argmin(db))
            ok, _ = _edge_free(check, full(trees[tb][ib]), full(q_new), args,
                               resolution)
            if ok:
                def backtrack(t, i):
                    out = []
                    while i >= 0:
                        out.append(trees[t][i])
                        i = parents[t][i]
                    return out
                pa = backtrack(ta, len(trees[ta]) - 1)[::-1]
                pb = backtrack(tb, ib)
                path = (pa + pb) if ta == 0 else (pb[::-1] + pa[::-1])
                break
        if path is None:
            return None

    # shortcut smoothing
    path = [np.asarray(p) for p in path]
    for _ in range(shortcut_iters):
        if len(path) <= 2:
            break
        i, j = sorted(rng.choice(len(path), 2, replace=False))
        if j - i < 2:
            continue
        ok, _ = _edge_free(check, full(path[i]), full(path[j]), args,
                           resolution)
        if ok:
            path = path[: i + 1] + path[j:]

    # densify to resolution for execution
    out = []
    for a, b in zip(path[:-1], path[1:]):
        n = max(2, int(np.ceil(np.abs(b - a).max() / resolution)) + 1)
        seg = a[None] + (b - a)[None] * np.linspace(0, 1, n)[:, None]
        out.append(seg[:-1])
    out.append(path[-1][None])
    qa_path = np.concatenate(out)
    return np.stack([full(qa) for qa in qa_path])
