"""The physics world: articulation + free rigid actors + contacts, stepped
for B envs at once (port of gsworld_tpu/physics/world.py, env axis
written out).

One control step = ``sim_freq/control_freq`` substeps; each substep:

  1. articulation free dynamics (CRBA/RNEA + implicit PD, dynamics.py)
  2. actor free velocities (gravity)
  3. contact generation (contact.py) between static pair lists
  4. unified velocity-level solve: an exact active-set Newton presolve of
     the normal impulses on the dense Delassus matrix, then projected
     Jacobi iterations with mass splitting over all contact rows at once;
     Coulomb friction via box clamp, Baumgarte position stabilization
  5. semi-implicit Euler integration of joints and actor poses

Per-pair contact forces are accumulated and exposed for grasp checks.

Every shape is static (rows are masked, never compacted) and no function
reads a device value on the host, so a control step can be captured into
a CUDA graph.  All static scene data, including the index tables and
one-hot matrices of the row layout, are tensors built once at scene build
(:func:`scene_tensors`); sums over rows are products with those one-hot
matrices, which are deterministic where a scatter's atomics are not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from gsworld_tpu_torch.core.maths import (
    quat_multiply,
    quat_normalize,
    quat_to_matrix,
)
from gsworld_tpu_torch.physics import contact as C
from gsworld_tpu_torch.physics import dynamics as D
from gsworld_tpu_torch.physics.kinematics import ArticulationModel
from gsworld_tpu_torch.utils import kernels

cross = torch.linalg.cross

# ---------------------------------------------------------------------- #
# Static scene description
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ActorTable:
    """Static data for free rigid actors, stacked (A actors, K support
    points, F hull faces; K/F padded per actor)."""

    names: Tuple[str, ...]
    mass: np.ndarray       # (A,)
    inertia: np.ndarray    # (A, 3, 3) body frame about COM (COM = body origin)
    sup_pts: np.ndarray    # (A, K, 3)
    faces: np.ndarray      # (A, F, 4)
    friction: np.ndarray   # (A,)

    @property
    def num(self) -> int:
        return len(self.names)


@dataclasses.dataclass(frozen=True)
class SolverParams:
    # with the exact normal presolve carrying the stiff direction, the
    # Jacobi loop only converges friction + coupling; ~30 iterations are
    # what the grasp-hold friction impulse needs to build
    iterations: int = 32
    relaxation: float = 1.0
    baumgarte: float = 0.1
    slop: float = 0.005
    # cap on the Baumgarte push-out velocity, kept low: large values eject
    # objects squeezed by force-limited PD grippers
    max_pen_vel: float = 0.05
    # contact-patch reduction: rows kept per collision pair
    contact_patch: int = 6
    # speculative contact offset: rows activate while still this far
    # apart, with a negative bias pen/h that allows approach exactly to
    # touching
    contact_margin: float = 0.008
    # SAT axis preference for link-actor pairs: the directed query whose
    # winning face is an actor facet only wins the pair's shared normal if
    # it is shallower than the flat link face axis by more than this
    link_face_pref: float = 0.003
    # safety valve: an actor whose presolve delta exceeds |v_free| + this
    # falls back to the gated warm start for the substep
    max_kick_lin: float = 0.5
    max_kick_ang: float = 25.0
    # friction stage of the exact presolve: "off" (friction builds in the
    # Jacobi polish), "qp" or "pgs".  A plain field; nothing in the
    # process environment changes it.
    friction_stage: str = "off"


@dataclasses.dataclass(frozen=True)
class SceneTensors:
    """Everything static that a step reads, on one device.  L links, A
    actors, K support points, F faces, P planes, Q directed hull queries,
    R rows per pair, C contact rows, n_la (link, actor) pairs."""

    device: torch.device
    R: int
    la_spans: Tuple[Tuple[int, int], ...]
    # actors and links
    sup_pts: torch.Tensor        # (A, K, 3)
    a_faces: torch.Tensor        # (A, F, 4)
    inv_mass: torch.Tensor       # (A,)
    inertia_inv: torch.Tensor    # (A, 3, 3) body frame
    a_friction: torch.Tensor     # (A,)
    planes: torch.Tensor         # (P, 4 or 8)
    link_pts: torch.Tensor       # (L, K, 3)
    link_faces: torch.Tensor     # (L, F, 4)
    link_friction: torch.Tensor  # (L,)
    kp: torch.Tensor             # (dof,)
    kd: torch.Tensor
    force_limit: torch.Tensor
    h_gravity: torch.Tensor      # (3,) h * g
    ez: torch.Tensor             # (3,)
    ex: torch.Tensor
    eye_2c: torch.Tensor         # (2C, 2C)
    # directed hull queries over the unified body table (links, actors)
    q_src: torch.Tensor          # (Q,) int64
    q_dst: torch.Tensor          # (Q,)
    q_part: torch.Tensor         # (Q,) partner query (q ^ 1)
    q_even: torch.Tensor         # (Q,) bool
    q_pref_unit: torch.Tensor    # (Q,) 1 where link_face_pref applies
    # contact rows
    body_a: torch.Tensor         # (C,) int64, -1 = world
    body_b: torch.Tensor
    jac_mask: torch.Tensor       # (C, dof) +-1/0 ancestor mask of the row
    idx_a: torch.Tensor          # (C,) actor index, clipped to [0, A)
    idx_b: torch.Tensor
    is_act_a: torch.Tensor       # (C, 1) f32 0/1
    is_act_b: torch.Tensor
    im_a: torch.Tensor           # (C,) inverse mass of body a, 0 if no actor
    im_b: torch.Tensor
    seg_a: torch.Tensor          # (C,) actor index, A = trash
    seg_b: torch.Tensor
    oh_a: torch.Tensor           # (C, A) one-hot of seg_a without trash
    oh_b: torch.Tensor
    oh_a1: torch.Tensor          # (C, A + 1) with the trash column
    oh_b1: torch.Tensor
    link_a: torch.Tensor         # (C,) link index, L = trash
    link_b: torch.Tensor
    ohl_a: torch.Tensor          # (C, L + 1), trash column zero
    ohl_b: torch.Tensor
    la_sel: torch.Tensor         # (n_la, C) +1 link is body a, -1 body b


@dataclasses.dataclass(frozen=True)
class PhysicsScene:
    model: Optional[ArticulationModel]
    actors: ActorTable
    planes: np.ndarray                 # (P, 4) static planes (n, d)
    link_collision_pts: np.ndarray     # (L, Kl, 3) padded link support pts
    link_faces: np.ndarray             # (L, F, 4)
    link_friction: np.ndarray          # (L,)
    la_pairs: np.ndarray               # (n_la, 2) (link_idx, actor_idx)
    aa_pairs: np.ndarray               # (n_aa, 2) (actor_i, actor_j)
    solver: SolverParams = SolverParams()
    kp: np.ndarray = None              # (dof,) PD gains
    kd: np.ndarray = None
    force_limit: np.ndarray = None
    # the controllers balance the robot's passive forces every sim step
    # (gravity + coriolis applied as unclipped external force); without it
    # the kp=1e3 arm sags ~1.5 cm at the TCP
    compensate_passive: bool = True
    sim_freq: int = 120
    control_freq: int = 40
    # the arrays above as tensors on the scene's device (scene_tensors)
    tensors: Optional[SceneTensors] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def substeps(self) -> int:
        return self.sim_freq // self.control_freq

    @property
    def h(self) -> float:
        return 1.0 / self.sim_freq


def contact_row_count(scene: "PhysicsScene") -> int:
    """Static number of candidate contact rows (see _generate_contacts);
    per-pair counts are capped by the contact-patch reduction."""
    A = scene.actors.num
    K = scene.actors.sup_pts.shape[1] if A else 0
    R = min(scene.solver.contact_patch, K) if K else 0
    n = scene.planes.shape[0] * A * R
    n += len(np.asarray(scene.aa_pairs).reshape(-1, 2)) * 2 * R
    n += len(np.asarray(scene.la_pairs).reshape(-1, 2)) * 2 * R
    return n


def scene_tensors(scene: PhysicsScene, device) -> SceneTensors:
    """The static tensors of ``scene`` on ``device``, with the row layout
    of :func:`_generate_contacts`: (P, A, R) plane rows, then R rows per
    directed hull query; the queries are the two directions of each
    actor-actor pair, then of each link-actor pair.  Body ids: links
    0..L-1, actors L..L+A-1, -1 the static world."""
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.long, device=device)
    model = scene.model
    if model is None or model.dof == 0:
        raise NotImplementedError("a scene without an articulation")
    L, nd = model.num_links, model.dof
    A = scene.actors.num
    K = scene.actors.sup_pts.shape[1] if A else 0
    P = scene.planes.shape[0]
    R = min(scene.solver.contact_patch, K) if K else 0
    if A and (scene.link_collision_pts.shape[1] != K
              or scene.link_faces.shape[1] != scene.actors.faces.shape[1]):
        raise ValueError("links and actors must be padded to the same "
                         "numbers of support points and faces")
    aa = np.asarray(scene.aa_pairs).reshape(-1, 2)
    la = np.asarray(scene.la_pairs).reshape(-1, 2)

    body_a = [L + a for _ in range(P) for a in range(A) for _ in range(R)]
    body_b = [-1] * len(body_a)
    q_src, q_dst, q_pref = [], [], []
    for (i, j) in aa:
        for (s, d) in ((int(i), int(j)), (int(j), int(i))):
            q_src.append(L + s)
            q_dst.append(L + d)
            q_pref.append(0.0)
    la_spans = []
    for (l, a) in la:
        l, a = int(l), int(a)
        start = len(body_a) + len(q_src) * R
        q_src += [l, L + a]
        q_dst += [L + a, l]
        # the link-points -> actor-hull query's axis is an actor facet
        # normal: penalised, flat link faces give grasp-stable axes
        q_pref += [1.0, 0.0]
        la_spans.append((start, start + 2 * R))
    for s, d in zip(q_src, q_dst):
        body_a += [s] * R
        body_b += [d] * R
    body_a = np.asarray(body_a, np.int64)
    body_b = np.asarray(body_b, np.int64)
    Cn = len(body_a)
    Q = len(q_src)

    anc = D._ancestor_dofs(model).astype(np.float32)          # (L, dof)
    is_link_a = (body_a >= 0) & (body_a < L)
    is_link_b = (body_b >= 0) & (body_b < L)
    jac_mask = (np.where(is_link_a[:, None], anc[np.clip(body_a, 0, L - 1)], 0)
                - np.where(is_link_b[:, None],
                           anc[np.clip(body_b, 0, L - 1)], 0))
    a_idx_a, a_idx_b = body_a - L, body_b - L
    is_act_a, is_act_b = a_idx_a >= 0, a_idx_b >= 0
    idx_a = np.clip(a_idx_a, 0, max(A - 1, 0))
    idx_b = np.clip(a_idx_b, 0, max(A - 1, 0))
    inv_mass = 1.0 / np.asarray(scene.actors.mass, np.float32)
    seg_a = np.where(is_act_a, a_idx_a, A)
    seg_b = np.where(is_act_b, a_idx_b, A)
    link_a = np.where(is_link_a, body_a, L)
    link_b = np.where(is_link_b, body_b, L)

    def one_hot(idx, n):
        return np.eye(n, dtype=np.float32)[idx]

    ohl_a, ohl_b = one_hot(link_a, L + 1), one_hot(link_b, L + 1)
    ohl_a[:, L] = 0.0
    ohl_b[:, L] = 0.0
    la_sel = np.zeros((len(la), Cn), np.float32)
    for pi, (l, a) in enumerate(la):
        la_sel[pi] = (((body_a == l) & (body_b == L + a)).astype(np.float32)
                      - ((body_a == L + a) & (body_b == l)))
    inertia_inv = (np.linalg.inv(np.asarray(scene.actors.inertia, np.float64))
                   if A else np.zeros((0, 3, 3)))
    t = lambda x: torch.as_tensor(np.array(x, np.float32), **f32)  # noqa: E731
    ti = lambda x: torch.as_tensor(np.asarray(x, np.int64), **i64)  # noqa: E731
    return SceneTensors(
        device=device, R=R, la_spans=tuple(la_spans),
        sup_pts=t(scene.actors.sup_pts), a_faces=t(scene.actors.faces),
        inv_mass=t(inv_mass), inertia_inv=t(inertia_inv),
        a_friction=t(scene.actors.friction), planes=t(scene.planes),
        link_pts=t(scene.link_collision_pts), link_faces=t(scene.link_faces),
        link_friction=t(scene.link_friction),
        kp=t(np.broadcast_to(scene.kp, (nd,))),
        kd=t(np.broadcast_to(scene.kd, (nd,))),
        force_limit=t(np.broadcast_to(scene.force_limit, (nd,))),
        h_gravity=t(np.float32(scene.h) * np.asarray(D.GRAVITY, np.float32)),
        ez=t([0.0, 0.0, 1.0]), ex=t([1.0, 0.0, 0.0]),
        eye_2c=torch.eye(2 * Cn, **f32),
        q_src=ti(q_src), q_dst=ti(q_dst), q_part=ti(np.arange(Q) ^ 1),
        q_even=torch.as_tensor(np.arange(Q) % 2 == 0, device=device),
        q_pref_unit=t(q_pref),
        body_a=ti(body_a), body_b=ti(body_b), jac_mask=t(jac_mask),
        idx_a=ti(idx_a), idx_b=ti(idx_b),
        is_act_a=t(is_act_a[:, None]), is_act_b=t(is_act_b[:, None]),
        im_a=t(np.where(is_act_a, inv_mass[idx_a], 0.0) if A else
               np.zeros(Cn)),
        im_b=t(np.where(is_act_b, inv_mass[idx_b], 0.0) if A else
               np.zeros(Cn)),
        seg_a=ti(seg_a), seg_b=ti(seg_b),
        oh_a=t(one_hot(seg_a, A + 1)[:, :A]),
        oh_b=t(one_hot(seg_b, A + 1)[:, :A]),
        oh_a1=t(one_hot(seg_a, A + 1)), oh_b1=t(one_hot(seg_b, A + 1)),
        link_a=ti(link_a), link_b=ti(link_b), ohl_a=t(ohl_a), ohl_b=t(ohl_b),
        la_sel=t(la_sel))


@dataclasses.dataclass
class WorldState:
    """Physics state of B envs."""

    qpos: torch.Tensor       # (B, dof)
    qvel: torch.Tensor       # (B, dof)
    root_pos: torch.Tensor   # (B, 3)
    root_quat: torch.Tensor  # (B, 4)
    a_pos: torch.Tensor      # (B, A, 3)
    a_quat: torch.Tensor     # (B, A, 4)
    a_lin: torch.Tensor      # (B, A, 3)
    a_ang: torch.Tensor      # (B, A, 3)
    # diagnostics / queries, refreshed each control step
    la_forces: torch.Tensor  # (B, n_la, 3) world force of actor on link
    # warm-start state of the contact solver (static row layout):
    # [lam_n, lam_t1, lam_t2, pos_xyz].  The position gates the warm
    # start: patch reduction reshuffles which support points own which
    # rows, and replaying a friction impulse at a relocated point kicks
    # light objects out of grasps.
    contact_lam: Optional[torch.Tensor] = None  # (B, C, 6)
    # per-env actor friction (defaults to the static scene values)
    a_friction: Optional[torch.Tensor] = None   # (B, A)
    # per-env actor geometric scale: scales collision support points (and
    # the GS render scale via the wrapper); mass and inertia stay nominal
    a_scale: Optional[torch.Tensor] = None      # (B, A)

    def replace(self, **kw) -> "WorldState":
        return dataclasses.replace(self, **kw)


WORLD_FIELDS = tuple(f.name for f in dataclasses.fields(WorldState))


def world_state_from_numpy(fields: Mapping[str, np.ndarray],
                           device="cuda") -> WorldState:
    """WorldState from numpy arrays keyed by field name, each with the
    leading env axis (e.g. ``np.asarray`` of each field of a batched JAX
    WorldState), so both packages step from the same state.  Fields that
    are missing or None stay None where the state allows it."""
    kw = {}
    for name in WORLD_FIELDS:
        v = fields.get(name)
        kw[name] = None if v is None else torch.as_tensor(
            np.array(v, np.float32), device=device)
    return WorldState(**kw)


def world_state_to_numpy(state: WorldState) -> Dict[str, np.ndarray]:
    return {name: None if getattr(state, name) is None
            else getattr(state, name).detach().cpu().numpy()
            for name in WORLD_FIELDS}


# ---------------------------------------------------------------------- #
# Contact generation
# ---------------------------------------------------------------------- #


def _generate_contacts(scene: PhysicsScene, kin, state: WorldState):
    """All candidate contacts (static count) of B envs: one vectorized
    plane test + one hull query over all directed pairs.  Returns
    (ContactSet, la_spans)."""
    st, sp = scene.tensors, scene.solver
    B, A = state.a_pos.shape[:2]
    K = st.sup_pts.shape[1] if A else 0
    P, R = st.planes.shape[0], st.R
    if R != (min(sp.contact_patch, K) if K else 0):
        raise ValueError("solver.contact_patch changed after the scene's "
                         "tensors were built")
    mg = sp.contact_margin
    sets: List[C.ContactSet] = []
    n_plane = P * A * R

    a_fric = (state.a_friction if state.a_friction is not None
              else st.a_friction.expand(B, A))
    sup = st.sup_pts
    if state.a_scale is not None:
        sup = sup * state.a_scale[:, :, None, None]
    a_pts_w = C.transform_points(state.a_pos, state.a_quat, sup)  # (B,A,K,3)

    # ---- actors vs planes: (B, P, A, K) in one shot ----
    if P and A:
        planes = st.planes
        pen = -(torch.einsum("nakj,pj->npak", a_pts_w, planes[:, :3])
                + planes[:, 3, None, None])
        if planes.shape[1] >= 8:
            x, y = a_pts_w[:, None, ..., 0], a_pts_w[:, None, ..., 1]
            inside = ((x >= planes[:, 4, None, None])
                      & (x <= planes[:, 5, None, None])
                      & (y >= planes[:, 6, None, None])
                      & (y <= planes[:, 7, None, None]))
            pen = torch.where(inside, pen, -1.0)
        pts_b = a_pts_w[:, None].expand(B, P, A, K, 3)
        pen, top = C.reduce_patch(pen, pts_b, R, margin=mg)   # (B, P, A, R)
        pen = pen.reshape(B, -1)
        sets.append(C.ContactSet(
            pos=torch.take_along_dim(pts_b, top[..., None], dim=3)
            .reshape(B, -1, 3),
            normal=planes[None, :, None, None, :3].expand(B, P, A, R, 3)
            .reshape(B, -1, 3),
            pen=pen, body_a=st.body_a[:n_plane], body_b=st.body_b[:n_plane],
            friction=a_fric[:, None, :, None].expand(B, P, A, R)
            .reshape(B, -1),
            active=pen > -mg))

    # ---- hull queries: all directed (src pts -> dst hull) pairs ----
    Q = st.q_src.shape[0]
    if Q:
        l_pts_w = C.transform_points(kin.link_pos, kin.link_quat,
                                     st.link_pts)             # (B, L, K, 3)
        L = l_pts_w.shape[1]
        pts_all = torch.cat([l_pts_w, a_pts_w], dim=1)
        pos_all = torch.cat([kin.link_pos, state.a_pos], dim=1)
        quat_all = torch.cat([kin.link_quat, state.a_quat], dim=1)
        a_faces = st.a_faces.expand(B, *st.a_faces.shape)
        if state.a_scale is not None:
            # scaling a hull scales its face-plane offsets (normals fixed)
            a_faces = torch.cat(
                [a_faces[..., :3],
                 a_faces[..., 3:] * state.a_scale[:, :, None, None]], dim=-1)
        faces_all = torch.cat(
            [st.link_faces.expand(B, *st.link_faces.shape), a_faces], dim=1)
        fric_all = torch.cat([st.link_friction.expand(B, L), a_fric], dim=1)

        src_pts = pts_all[:, st.q_src]                        # (B, Q, K, 3)
        inside, depth, sd, nrm_f = C.hull_query_sat(
            src_pts, pos_all[:, st.q_dst], quat_all[:, st.q_dst],
            faces_all[:, st.q_dst], margin=mg)
        # SAT axis per undirected pair: directed queries come in adjacent
        # (q, q^1) partner pairs; the pair's contact normal is the
        # minimal-depth face axis across both dst hulls, and only the
        # query owning the winning face emits rows (one shared patch
        # normal: per-point facet normals let grasped objects squirt out
        # of the friction cone)
        best_d, best_f = depth.min(dim=-1)                    # (B, Q)
        part = st.q_part
        overlap = torch.minimum(best_d, best_d[:, part]) > -mg
        score = best_d + st.q_pref_unit * sp.link_face_pref
        win = torch.where(st.q_even, score <= score[:, part],
                          score < score[:, part])
        n_win = torch.take_along_dim(
            nrm_f, best_f[..., None, None], dim=2)[:, :, 0]   # (B, Q, 3)
        pen = -torch.take_along_dim(
            sd, best_f[..., None, None], dim=3)[..., 0]       # (B, Q, K)
        ok = inside & (overlap & win)[..., None]
        pen = torch.where(ok, pen, -1.0)
        pen, top = C.reduce_patch(pen, src_pts, R, margin=mg)  # (B, Q, R)
        pen = pen.reshape(B, -1)
        mu = 0.5 * (fric_all[:, st.q_src] + fric_all[:, st.q_dst])
        sets.append(C.ContactSet(
            pos=torch.take_along_dim(src_pts, top[..., None], dim=2)
            .reshape(B, -1, 3),
            normal=n_win[:, :, None].expand(B, Q, R, 3).reshape(B, -1, 3),
            pen=pen, body_a=st.body_a[n_plane:], body_b=st.body_b[n_plane:],
            friction=mu[:, :, None].expand(B, Q, R).reshape(B, -1),
            active=pen > -mg))

    if not sets:
        z = state.a_pos.new_zeros((B, 0))
        return C.ContactSet(pos=z[..., None].expand(B, 0, 3),
                            normal=z[..., None].expand(B, 0, 3), pen=z,
                            body_a=st.body_a, body_b=st.body_b, friction=z,
                            active=z > 0), st.la_spans
    return C.concat_contacts(sets), st.la_spans


def _tangent_basis(n, ez, ex):
    """Two unit tangents per normal (..., 3) -> (..., 3), (..., 3); ``ez``
    and ``ex`` are the unit axes on n's device."""
    ref = torch.where(n[..., 2:3].abs() < 0.9, ez, ex)
    t1 = cross(n, ref)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True).clamp_min(1e-9)
    return t1, cross(n, t1)


class _Factor:
    """A batch of symmetric positive definite matrices factored once
    (Cholesky, no check on the host) and solved against several right-hand
    sides by two triangular solves: the friction QP's (2C, 2C) systems and
    the plain version of the normal stage.  These routines stay in
    cuSOLVER's batched factorization and cuBLAS, which a CUDA graph can
    capture; ``cholesky_solve`` and the LU routines go through MAGMA for a
    batch, which allocates during capture (tools/solve_times.py times
    them)."""

    def __init__(self, A):
        self.L = torch.linalg.cholesky_ex(A).L

    def solve(self, b):
        """b (B, n) -> x (B, n)."""
        y = torch.linalg.solve_triangular(self.L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(self.L.transpose(-1, -2), y,
                                             upper=True)[..., 0]


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


def _tikhonov(Am, eye):
    return (Am + 1e-3 * torch.diag_embed(torch.diagonal(Am, dim1=-2, dim2=-1))
            + 1e-9 * eye)


def _masked(Am, m):
    """Rows and columns outside ``m`` replaced by the identity."""
    return (torch.where(m[:, :, None] & m[:, None, :], Am, 0.0)
            + torch.diag_embed((~m).to(Am.dtype)))


NEWTON_ITERS = 7      # active-set Newton steps of the normal stage
NEWTON_REFINES = 2    # refinements against the unregularized matrix a step


def normal_newton_reference(An_raw, act_mask, rhs, x_init):
    """Plain version of :func:`normal_newton` (same inputs and output):
    each step factors the masked, Tikhonov-regularized system by
    ``_Factor`` and solves it three times."""
    n = An_raw.shape[-1]
    An = _tikhonov(An_raw, torch.eye(n, dtype=An_raw.dtype,
                                     device=An_raw.device))
    x = x_init.clamp_min(0.0)
    act = act_mask & ((x > 0.0) | (rhs < 0.0))
    for _ in range(NEWTON_ITERS):
        fac = _Factor(_masked(An, act))
        A_raw = _masked(An_raw, act)
        rhs_m = torch.where(act, rhs, 0.0)
        x = fac.solve(-rhs_m)
        for _ in range(NEWTON_REFINES):
            x = x - fac.solve(_matvec(A_raw, x) + rhs_m)
        x = torch.where(act, x, 0.0)                      # unclamped on act
        w = _matvec(An_raw, x) + rhs
        act = act_mask & (x > w)
    return torch.where(act, x, 0.0).clamp_min(0.0)


_newton_limits = {}   # device index -> normal_newton_limits


def normal_newton_limits(dev: torch.device):
    """(rows up to which csrc/contact_newton.cu keeps the matrix beside
    its factor in shared memory, rows up to which the factor fits at
    all) on ``dev``, from its shared memory per block."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _newton_limits:
        lib = kernels.build_kernels()
        with torch.cuda.device(idx):
            got = [lib.gsw_normal_newton_max_rows(k) for k in (1, 0)]
        for v in got:
            if v < 0:
                kernels.check(lib, -v, "normal_newton_limits")
        _newton_limits[idx] = tuple(got)
    return _newton_limits[idx]


def normal_newton(An_raw, act_mask, rhs, x_init):
    """The normal impulses (B, C) of the contact LCP w = An_raw x + rhs,
    x >= 0, w >= 0, x w = 0 on the rows of ``act_mask``, by semismooth
    (min-map) Newton on min(x, w) = 0: solve w = 0 on the active set,
    then switch act <- {x > w}, NEWTON_ITERS times from ``x_init``
    clamped at 0.  Tikhonov regularization keeps the masked solve
    well-posed (rows on a sandwiched body are redundant); its compliance
    bias is removed by NEWTON_REFINES refinements against the
    unregularized matrix.

    ``An_raw`` (B, C, C) f32, the normal block of the Delassus matrix,
    any strides; ``act_mask`` (B, C) bool, the rows that may push;
    ``rhs`` and ``x_init`` (B, C) f32.  On the card one launch of
    csrc/contact_newton.cu (one block per env), which sums in the order
    of the plain version's batched library routines: its bits on the
    loops' systems at 64 envs, float32 rounding at one env; on the CPU
    the plain version."""
    if An_raw.device.type == "cpu":
        return normal_newton_reference(An_raw, act_mask, rhs, x_init)
    dev = kernels.cuda_device(An_raw, "normal_newton")
    with torch.cuda.device(dev):     # the stream's device is current
        if An_raw.dim() != 3 or An_raw.shape[1] != An_raw.shape[2]:
            raise ValueError(f"An_raw has shape {tuple(An_raw.shape)}, "
                             "expected (B, C, C)")
        B, n = An_raw.shape[:2]
        if An_raw.dtype != torch.float32:
            raise TypeError(f"An_raw has dtype {An_raw.dtype}, expected "
                            "torch.float32")
        act_mask, rhs, x_init = (t.contiguous()
                                 for t in (act_mask, rhs, x_init))
        for name, t, dt in (("act_mask", act_mask, torch.bool),
                            ("rhs", rhs, torch.float32),
                            ("x_init", x_init, torch.float32)):
            kernels.require(t, name, dt, (B, n), dev)
        lib = kernels.build_kernels()
        in_shared, most = normal_newton_limits(dev)
        if n > most:
            raise ValueError(
                f"normal_newton: {n} contact rows; the kernel's factor "
                f"fits shared memory up to {most} rows")
        out = torch.empty((B, n), dtype=torch.float32, device=dev)
        # above in_shared rows An_raw on the mask's rows waits in a copy
        # that the kernel writes once (in L2) instead of shared memory
        scratch = (None if n <= in_shared else torch.empty(
            (B, n * n), dtype=torch.float32, device=dev))
        sB, sI, sJ = An_raw.stride()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsw_normal_newton(
            An_raw.data_ptr(), sB, sI, sJ, act_mask.data_ptr(),
            rhs.data_ptr(), x_init.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            B, n, NEWTON_ITERS, NEWTON_REFINES, stream)
        kernels.check(lib, rc, "normal_newton")
        kernels.launch_counts["normal_newton"] += 1
        return out


def _solve_contacts(scene: PhysicsScene, kin, contacts: C.ContactSet,
                    Minv_eff, qvel_free, a_lin_free, a_ang_free,
                    state: WorldState, lam0=None):
    """Contact solve of B envs.  Returns (qvel, a_lin, a_ang, lam_state
    (B, C, 6) = impulses along (n, t1, t2) and the contact positions)."""
    sp, st = scene.solver, scene.tensors
    h = scene.h
    B, nC = contacts.pen.shape
    A = scene.actors.num
    if nC == 0:
        return (qvel_free, a_lin_free, a_ang_free,
                qvel_free.new_zeros((B, 0, 6)))
    if lam0 is None:
        lam0 = qvel_free.new_zeros((B, nC, 6))
    # warm-start gating: only replay impulses whose contact point is
    # still (nearly) where it was when the impulse was computed
    matched = (torch.sum((contacts.pos - lam0[..., 3:6]) ** 2, dim=-1)
               < 0.005 ** 2)
    lam0 = torch.where(matched[..., None], lam0[..., :3], 0.0)

    n = contacts.normal
    t1, t2 = _tangent_basis(n, st.ez, st.ex)
    dirs = torch.stack([n, t1, t2], dim=2)                # (B, C, 3, 3)

    # ---- robot jacobian rows: J[c, d, dof] ----
    Sw, Sv = kin.S[..., :3], kin.S[..., 3:]               # (B, dof, 3)
    # velocity of dof d at point x: Sv_d + Sw_d x x
    vel_at = Sv[:, None] + cross(Sw[:, None],
                                 contacts.pos[:, :, None])  # (B,C,dof,3)
    J_rob = (torch.einsum("ncij,ncdj->ncid", dirs, vel_at)
             * st.jac_mask[:, None, :])                   # (B, C, 3, dof)
    MinvJt = torch.einsum("nde,ncie->ncid", Minv_eff, J_rob)
    D_rob = torch.sum(J_rob * MinvJt, dim=-1)             # (B, C, 3)

    # ---- actor terms ----
    inv_mass = st.inv_mass
    Rw = quat_to_matrix(state.a_quat)                     # (B, A, 3, 3)
    # world-frame inverse inertia per actor
    Iw_inv = Rw @ st.inertia_inv @ Rw.transpose(-1, -2)
    r_a = (contacts.pos - state.a_pos[:, st.idx_a]) * st.is_act_a
    r_b = (contacts.pos - state.a_pos[:, st.idx_b]) * st.is_act_b
    rxd_a = cross(r_a[:, :, None], dirs)                  # (B, C, 3, 3)
    rxd_b = cross(r_b[:, :, None], dirs)
    im_a, im_b = st.im_a, st.im_b                         # (C,)
    Ii_a = Iw_inv[:, st.idx_a] * st.is_act_a[..., None]
    Ii_b = Iw_inv[:, st.idx_b] * st.is_act_b[..., None]
    D_act = ((im_a + im_b)[:, None]
             + torch.einsum("ncij,ncjk,ncik->nci", rxd_a, Ii_a, rxd_a)
             + torch.einsum("ncij,ncjk,ncik->nci", rxd_b, Ii_b, rxd_b))
    Dg = (D_rob + D_act).clamp_min(1e-9)                  # (B, C, 3)

    # Baumgarte bias: desired separating normal velocity.  Speculative
    # rows (pen < 0: within contact_margin but not yet touching) get a
    # negative bias pen/h: the pair may approach at most the remaining
    # distance this substep.
    b = torch.where(
        contacts.pen >= 0.0,
        (sp.baumgarte / h * (contacts.pen - sp.slop).clamp_min(0.0))
        .clamp_max(sp.max_pen_vel),
        contacts.pen / h)

    act_mask = contacts.active
    # --- mass splitting: Jacobi diverges when several active rows
    # push the same body; divide each row's step by the number of
    # active rows sharing its most-contended body.  Robot rows are
    # counted per link.  The actor counts keep their trash column: a
    # row whose other body is no actor reads the number of active
    # rows with a non-actor side, as the JAX package's scatter does.
    af = act_mask.to(lam0.dtype)
    cnt_act = af @ st.oh_a1 + af @ st.oh_b1               # (B, A + 1)
    cnt_link = af @ st.ohl_a + af @ st.ohl_b              # (B, L + 1)
    cnt_rob_row = torch.maximum(cnt_link[:, st.link_a],
                                cnt_link[:, st.link_b])
    n_shared = torch.maximum(
        torch.maximum(cnt_act[:, st.seg_a], cnt_act[:, st.seg_b]),
        cnt_rob_row)
    split = 1.0 / n_shared.clamp_min(1.0)                 # (B, C)
    # warm start: keep impulses only on rows still active this substep
    lam0 = torch.where(act_mask[..., None], lam0, 0.0)

    def body_vel(qvel, a_lin, a_ang):
        # relative velocity along each dir: J_rob qvel + actor terms
        v = torch.einsum("ncid,nd->nci", J_rob, qvel)
        va = (a_lin[:, st.idx_a] * st.is_act_a
              + cross(a_ang[:, st.idx_a] * st.is_act_a, r_a))
        vb = (a_lin[:, st.idx_b] * st.is_act_b
              + cross(a_ang[:, st.idx_b] * st.is_act_b, r_b))
        return v + torch.einsum("ncij,ncj->nci", dirs, va - vb)  # (B, C, 3)

    def deltas_from_lam(lam):
        # robot
        dqvel = torch.einsum("ncid,nci->nd", MinvJt, lam)
        # actors: impulse world vectors, summed per actor by products
        # with the static one-hot matrices
        Pw = torch.einsum("ncij,nci->ncj", dirs, lam)         # (B, C, 3)
        dlin = (torch.einsum("ca,ncj->naj", st.oh_a, Pw * im_a[:, None])
                - torch.einsum("ca,ncj->naj", st.oh_b, Pw * im_b[:, None]))
        wa = torch.einsum("ncij,ncj->nci", Ii_a, cross(r_a, Pw))
        wb = torch.einsum("ncij,ncj->nci", Ii_b, cross(r_b, Pw))
        dang = (torch.einsum("ca,ncj->naj", st.oh_a, wa)
                - torch.einsum("ca,ncj->naj", st.oh_b, wb))
        return dqvel, dlin, dang

    # ---- the Delassus matrix ------------------------------------------ #
    # The row velocities are linear in the impulses:
    #   v(lam) = v_free + W lam,   W = J Minv J^T + G M^-1 G^T  (3C x 3C)
    # over all rows and their three directions.  The JAX package applies
    # W matrix-free in its Jacobi sweep (a scatter to the bodies and a
    # gather back, ~50 small fused ops) and builds only the normal block
    # explicitly; here one sweep is one batched matrix-vector product with
    # the dense W, whose normal-normal block is the Newton stage's matrix
    # and whose tangent block the friction stages'.
    n3 = 3 * nC
    d3 = dirs.reshape(B, n3, 3)
    J3 = J_rob.reshape(B, n3, -1)
    W = torch.einsum("ncd,nde,nfe->ncf", J3, Minv_eff, J3)
    if A:
        oh_a3 = st.oh_a.repeat_interleave(3, dim=0)       # (3C, A)
        oh_b3 = st.oh_b.repeat_interleave(3, dim=0)
        G_lin = (oh_a3 - oh_b3)[None, :, :, None] * d3[:, :, None, :]
        G_ang = (oh_a3[None, :, :, None]
                 * rxd_a.reshape(B, n3, 1, 3)
                 - oh_b3[None, :, :, None]
                 * rxd_b.reshape(B, n3, 1, 3))            # (B, 3C, A, 3)
        W = W + torch.einsum("ncak,a,ndak->ncd", G_lin, inv_mass, G_lin)
        W = W + torch.einsum("ncak,nakl,ndal->ncd", G_ang, Iw_inv, G_ang)
    v_free = body_vel(qvel_free, a_lin_free, a_ang_free)  # (B, C, 3)
    W5 = W.reshape(B, nC, 3, nC, 3)

    def vel_after(lam):
        """Row velocities (B, C, 3) after the impulses ``lam``."""
        return v_free + _matvec(W, lam.reshape(B, n3)).reshape(B, nC, 3)

    step = (sp.relaxation * split)[..., None] / Dg            # (B, C, 3)
    b3 = torch.cat([b[..., None], torch.zeros_like(lam0[..., 1:])], dim=-1)

    def iteration(lam):
        new = lam - step * (vel_after(lam) - b3)
        # normal update, then the friction box clamp
        ln = new[..., :1].clamp_min(0.0)
        lim = contacts.friction[..., None] * ln
        lt = torch.clamp(new[..., 1:], -lim, lim)
        return torch.where(act_mask[..., None], torch.cat([ln, lt], dim=-1),
                           0.0)

    # ---- exact normal presolve --------------------------------------- #
    # Matrix-free Jacobi cannot bridge extreme mass ratios: a PD-driven
    # finger squeezing a 4 g can forms a heavy-light-heavy sandwich whose
    # force transmission needs O(m_link/m_can) sweeps.  The contact count
    # is small and static, so the normal LCP is solved on the normal block
    # of W with a few active-set Newton steps (``normal_newton``: dense
    # (C, C) solves).  The Jacobi loop then only polishes friction and
    # the normal/friction coupling.
    An_raw = W5[:, :, 0, :, 0]
    if sp.friction_stage in ("qp", "pgs"):
        At_raw = W5[:, :, 1:, :, 1:].reshape(B, 2 * nC, 2 * nC)
        At = _tikhonov(At_raw, st.eye_2c)

    def newton(lam_f, x_init):
        """``normal_newton`` with the friction impulses ``lam_f`` (B, C,
        2) folded into the free velocity, so normals and friction stagger
        to a consistent pair."""
        lam_nf = torch.cat([torch.zeros_like(lam_f[..., :1]), lam_f], dim=-1)
        rhs = vel_after(lam_nf)[..., 0] - b                   # w = An x + rhs
        return normal_newton(An_raw, act_mask, rhs, x_init)

    # ---- exact friction solves (experiments; the main path runs "off") #
    def friction_rhs(x_n):
        lim2 = (contacts.friction * x_n).repeat_interleave(2, dim=-1)
        lam_no = torch.cat([x_n[..., None],
                            torch.zeros_like(lam0[..., 1:])], dim=-1)
        r_t = vel_after(lam_no)[..., 1:].reshape(B, 2 * nC)
        okr = act_mask.repeat_interleave(2, dim=-1) & (lim2 > 0.0)
        return lim2, r_t, okr

    def friction_qp(x_n, y_init):
        """Box QP: min 1/2 y^T At y + y^T r  s.t. |y_i| <= mu_i x_n_i, by
        projected Newton on the free set."""
        lim2, r_t, okr = friction_rhs(x_n)
        y = torch.clamp(y_init.reshape(B, 2 * nC), -lim2, lim2)
        for _ in range(3):
            g = _matvec(At_raw, y) + r_t
            at_hi = y >= lim2 * (1.0 - 1e-5)
            at_lo = y <= -lim2 * (1.0 - 1e-5)
            free = okr & ~((at_hi & (g <= 0.0)) | (at_lo & (g >= 0.0)))
            y_b = torch.where(free, 0.0, torch.where(okr, y, 0.0))
            fac = _Factor(_masked(At, free))
            A_raw = _masked(At_raw, free)
            rr = torch.where(free, r_t + _matvec(At_raw, y_b), 0.0)
            yf = fac.solve(-rr)
            yf = yf - fac.solve(_matvec(A_raw, yf) + rr)
            y = torch.clamp(torch.where(free, yf, y_b), -lim2, lim2)
        return y.reshape(B, nC, 2)

    def friction_pgs(x_n, y_init):
        """Box-projected diagonally-preconditioned Jacobi on the exact
        tangential system: monotone for PSD At."""
        lim2, r_t, okr = friction_rhs(x_n)
        Dt = torch.diagonal(At_raw, dim1=-2, dim2=-1).clamp_min(1e-9)
        split2 = split.repeat_interleave(2, dim=-1)
        y = torch.where(
            okr, torch.clamp(y_init.reshape(B, 2 * nC), -lim2, lim2), 0.0)
        for _ in range(24):
            g = _matvec(At_raw, y) + r_t
            y = torch.clamp(y - split2 * g / Dt, -lim2, lim2)
            y = torch.where(okr, y, 0.0)
        return y.reshape(B, nC, 2)

    x = newton(lam0[..., 1:], lam0[..., 0])
    if sp.friction_stage == "qp":
        y = friction_qp(x, lam0[..., 1:])
        x = newton(y, x)
    elif sp.friction_stage == "pgs":
        y = friction_pgs(x, lam0[..., 1:])
        x = newton(y, x)
    elif sp.friction_stage == "off":
        y = lam0[..., 1:]       # friction is left to the polish
    else:
        raise ValueError(f"friction_stage {sp.friction_stage!r}")
    lam_ps = torch.cat([x[..., None], y], dim=-1)

    # ---- kick safety valve ---------------------------------------- #
    # The exact presolve can return huge near-cancelling impulse sets
    # on ill-conditioned active sets; their residual arrives as an
    # m/s-scale kick.  Any actor whose presolve delta exceeds the free
    # velocity plus the bias budget falls back to the gated warm start
    # and lets the monotone polish carry the substep.
    if A:
        _, dlin_ps, dang_ps = deltas_from_lam(lam_ps)
        norm = lambda v: torch.linalg.norm(v, dim=-1)     # noqa: E731
        bad_a = ((norm(dlin_ps) > norm(a_lin_free) + sp.max_kick_lin)
                 | (norm(dang_ps) > norm(a_ang_free) + sp.max_kick_ang))
        bad_pad = torch.cat([bad_a, torch.zeros_like(bad_a[:, :1])],
                            dim=1)
        row_bad = bad_pad[:, st.seg_a] | bad_pad[:, st.seg_b]
        lam_ps = torch.where(row_bad[..., None], lam0, lam_ps)

    lam = lam_ps
    for _ in range(sp.iterations):
        lam = iteration(lam)
    dqvel, dlin, dang = deltas_from_lam(lam)
    lam_state = torch.cat([lam, contacts.pos], dim=-1)
    return (qvel_free + dqvel, a_lin_free + dlin, a_ang_free + dang,
            lam_state)


# ---------------------------------------------------------------------- #
# Stepping
# ---------------------------------------------------------------------- #


def physics_substep(scene: PhysicsScene, state: WorldState, q_target):
    model, st = scene.model, scene.tensors
    h = scene.h
    kin = D.compute_kinematics(model, state.qpos, state.root_pos,
                               state.root_quat)
    M = D.mass_matrix(model, kin)
    bias = D.bias_forces(model, kin, state.qvel)
    # passive-force balancing: the compensation torque (= bias at the
    # current state) enters as unclipped external force, exactly
    # cancelling gravity + coriolis in the free solve
    comp = bias if scene.compensate_passive else None
    qvel_free, Minv_eff = D.implicit_pd_velocity(
        model, M, bias, state.qpos, state.qvel, q_target, st.kp, st.kd,
        st.force_limit, h, tau_external=comp)
    a_lin_free = state.a_lin + st.h_gravity
    a_ang_free = state.a_ang

    contacts, _ = _generate_contacts(scene, kin, state)
    qvel, a_lin, a_ang, lam = _solve_contacts(
        scene, kin, contacts, Minv_eff, qvel_free, a_lin_free, a_ang_free,
        state, lam0=state.contact_lam)

    # per-(link, actor) pair contact force (world) on the link
    B = state.qpos.shape[0]
    if st.la_sel.shape[0] and contacts.pen.shape[1]:
        n = contacts.normal
        t1, t2 = _tangent_basis(n, st.ez, st.ex)
        Pw = (n * lam[..., 0:1] + t1 * lam[..., 1:2]
              + t2 * lam[..., 2:3]) / h
        la_forces = torch.einsum("pc,ncj->npj", st.la_sel, Pw)
    else:
        la_forces = state.qpos.new_zeros(
            (B, max(st.la_sel.shape[0], 1), 3))

    # limits + integration (articulation)
    qpos, qvel = D.integrate_joints(model, state.qpos, qvel, h)
    # actors
    a_pos = state.a_pos + h * a_lin
    wq = torch.cat([torch.zeros_like(a_ang[..., :1]), a_ang], dim=-1)
    a_quat = quat_normalize(state.a_quat + 0.5 * h *
                            quat_multiply(wq, state.a_quat))
    return WorldState(qpos=qpos, qvel=qvel, root_pos=state.root_pos,
                      root_quat=state.root_quat, a_pos=a_pos, a_quat=a_quat,
                      a_lin=a_lin, a_ang=a_ang, la_forces=la_forces,
                      contact_lam=lam, a_friction=state.a_friction,
                      a_scale=state.a_scale)


def control_step(scene: PhysicsScene, state: WorldState,
                 q_target) -> WorldState:
    """One control step = substeps at sim_freq with a fixed PD target.

    Pair contact forces are averaged over the substeps: instantaneous
    per-substep impulses carry the Baumgarte/PD limit-cycle ripple, while
    the substep mean matches a steady force (is_grasping thresholds at
    0.5 N)."""
    if scene.tensors is None:
        raise ValueError("the scene has no tensors: build it with "
                         "make_scene(..., device=...)")
    hist = []
    for _ in range(scene.substeps):
        state = physics_substep(scene, state, q_target)
        hist.append(state.la_forces)
    return state.replace(la_forces=torch.stack(hist).mean(dim=0))
