"""Actor/scene construction helpers (port of
gsworld_tpu/physics/builders.py): primitive + convex colliders with
inertia, and PhysicsScene assembly.  Host side numpy; ``make_scene`` leaves
the scene's tensors on the device it is given.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from benchmark.reference.gsw import constants
from benchmark.reference.gsw.physics import meshes
from benchmark.reference.gsw.physics.contact import hull_faces
from benchmark.reference.gsw.physics.kinematics import ArticulationModel
from benchmark.reference.gsw.physics.world import (
    ActorTable,
    PhysicsScene,
    SolverParams,
    scene_tensors,
)

DEFAULT_DENSITY = 10.0   # the DTC/YCB actors' density override
MAX_SUPPORT = 24
MAX_FACES = 32


@dataclasses.dataclass
class ActorDef:
    name: str
    sup_pts: np.ndarray        # (K, 3) body frame, COM at origin
    mass: float
    inertia: np.ndarray        # (3, 3) body frame about COM
    friction: float = 0.5
    faces: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.faces is None:
            self.faces = hull_faces(self.sup_pts, MAX_FACES)


def box_actor(name: str, half_size, density=DEFAULT_DENSITY,
              friction=0.5, mass=None) -> ActorDef:
    hx, hy, hz = [float(v) for v in half_size]
    if mass is None:
        mass = density * 8 * hx * hy * hz
    inertia = mass / 3.0 * np.diag([hy * hy + hz * hz,
                                    hx * hx + hz * hz,
                                    hx * hx + hy * hy])
    corners = np.array([[sx * hx, sy * hy, sz * hz]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    # face centers: vertex-in-hull narrowphase misses face-face contact of
    # equal-size boxes without interior-face sample points
    faces = np.array([[s * hx, 0, 0] for s in (-1, 1)]
                     + [[0, s * hy, 0] for s in (-1, 1)]
                     + [[0, 0, s * hz] for s in (-1, 1)])
    return ActorDef(name, np.concatenate([corners, faces]), mass, inertia,
                    friction)


def cylinder_actor(name: str, radius: float, half_length: float,
                   axis: str = "z", density=DEFAULT_DENSITY,
                   friction=0.5, mass=None, n_side=10) -> ActorDef:
    r, h = float(radius), float(half_length)
    if mass is None:
        mass = density * np.pi * r * r * 2 * h
    i_axis = 0.5 * mass * r * r
    i_perp = mass * (3 * r * r + 4 * h * h) / 12.0
    ang = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
    pts = np.concatenate([
        np.concatenate([ring, np.full((n_side, 1), h)], axis=1),
        np.concatenate([ring, np.full((n_side, 1), -h)], axis=1),
        # cap centers + equator (face-face contact needs interior points)
        np.asarray([[0.0, 0.0, h], [0.0, 0.0, -h]]),
        np.concatenate([ring, np.zeros((n_side, 1))], axis=1)])
    inertia = np.diag([i_perp, i_perp, i_axis])
    if axis == "x":
        pts = pts[:, [2, 0, 1]]
        inertia = np.diag([i_axis, i_perp, i_perp])
    elif axis == "y":
        pts = pts[:, [1, 2, 0]]
        inertia = np.diag([i_perp, i_axis, i_perp])
    return ActorDef(name, pts, mass, inertia, friction)


def convex_actor(name: str, points: np.ndarray, density=DEFAULT_DENSITY,
                 friction=0.5, mass=None,
                 max_support=MAX_SUPPORT) -> ActorDef:
    """Convex collider from a point cloud; COM approximated at the hull
    centroid, inertia from the support-point distribution."""
    pts = meshes.convex_support_points(points, max_support)
    com = pts.mean(axis=0)
    pts = pts - com
    aabb = pts.max(0) - pts.min(0)
    vol = float(np.prod(np.maximum(aabb, 1e-4))) * 0.6  # hull < box volume
    if mass is None:
        mass = density * vol
    # inertia of the uniform box with matching extents
    ex, ey, ez = aabb
    inertia = mass / 12.0 * np.diag([ey * ey + ez * ez,
                                     ex * ex + ez * ez,
                                     ex * ex + ey * ey])
    return ActorDef(name, pts, mass, inertia, friction)


def hull_mass_properties(verts: np.ndarray):
    """(volume, com, unit-density inertia about com) of the convex hull of
    ``verts`` via signed-tetrahedron integration over hull facets."""
    from scipy.spatial import ConvexHull
    verts = np.asarray(verts, np.float64)
    hull = ConvexHull(verts)
    ref = verts[hull.vertices].mean(0)
    vol = 0.0
    com = np.zeros(3)
    I = np.zeros((3, 3))
    for simplex in hull.simplices:
        a, b, c = verts[simplex] - ref
        # ref is interior to the hull, so facet tetrahedra are disjoint:
        # |v| is exact regardless of the simplex winding scipy returns
        v = abs(np.dot(a, np.cross(b, c))) / 6.0
        centroid = (a + b + c) / 4.0
        vol += v
        com += v * centroid
        # tetra inertia about ref (covariance form)
        pts = np.stack([np.zeros(3), a, b, c])
        Ccov = np.zeros((3, 3))
        for i in range(4):
            for j in range(4):
                w = 2.0 if i == j else 1.0
                Ccov += w * np.outer(pts[i], pts[j])
        Ccov *= v / 20.0
        I += np.trace(Ccov) * np.eye(3) - Ccov
    com /= max(vol, 1e-12)
    # parallel-axis shift from ref to com
    d = com
    I -= vol * ((d @ d) * np.eye(3) - np.outer(d, d))
    return float(vol), com + ref, I


def mesh_actor(name: str, mesh_path: str, scale: float = 1.0,
               density=DEFAULT_DENSITY, friction=0.5,
               max_support=MAX_SUPPORT) -> ActorDef:
    """Actor from a collision mesh file (the DTC/YCB ingestion path:
    convex collision + density 10).

    The mesh's convex hull supplies support points, face planes, and
    volumetric mass/inertia; geometry is recentered on the hull COM."""
    verts, _ = meshes.load_mesh(mesh_path)
    verts = verts * float(scale)
    vol, com, I_unit = hull_mass_properties(verts)
    mass = density * vol
    pts = meshes.convex_support_points(verts - com, max_support)
    return ActorDef(name, pts.astype(np.float32), float(mass),
                    (density * I_unit).astype(np.float32), friction)


def asset_collision_path(name: str,
                         asset_dir: Optional[str] = None) -> Optional[str]:
    """Find a collision mesh for an actor name under the assets layout
    (assets/collision/<name>.{ply,stl,obj}); None when absent."""
    import os
    roots = []
    if asset_dir:
        roots.append(asset_dir)
    env_dir = os.environ.get("GSWORLD_ASSET_DIR")
    if env_dir:
        roots.append(env_dir)
    # the data directory that also holds the robot specs
    roots.append(os.path.dirname(constants.ROBOT_SPEC_DIR))
    for root in roots:
        for sub in ("collision", "collision_meshes", ""):
            for ext in (".ply", ".stl", ".obj"):
                p = os.path.join(root, sub, name + ext)
                if os.path.isfile(p):
                    return p
    return None


def actor_from_asset(fallback: ActorDef, asset_dir: Optional[str] = None,
                     scale: float = 1.0,
                     density=DEFAULT_DENSITY) -> ActorDef:
    """Use the real collision mesh when the asset exists, else the
    primitive/hull fallback (real assets upgrade fidelity with no code
    change)."""
    path = asset_collision_path(fallback.name, asset_dir)
    if path is None:
        return fallback
    return mesh_actor(fallback.name, path, scale=scale, density=density,
                      friction=fallback.friction)


def _pad_points(arrs: Sequence[np.ndarray], k: int) -> np.ndarray:
    """Pad each (Ki, 3) to (k, 3) with far-away points: they never penetrate
    anything, so the padded rows stay inactive (duplicated points would make
    redundant active rows, which break Jacobi convergence)."""
    out = []
    for a in arrs:
        a = np.asarray(a, np.float32).reshape(-1, 3)
        if a.shape[0] == 0:
            a = np.zeros((1, 3), np.float32)
        if a.shape[0] > k:
            a = meshes.farthest_point_sample(a, k).astype(np.float32)
        reps = np.tile(np.asarray([[1e7, 1e7, 1e7]], np.float32),
                       (k - a.shape[0], 1))
        out.append(np.concatenate([a, reps]))
    return np.stack(out)


def build_actor_table(defs: Sequence[ActorDef],
                      max_support=MAX_SUPPORT) -> ActorTable:
    if not defs:
        return ActorTable(names=(), mass=np.zeros(0),
                          inertia=np.zeros((0, 3, 3)),
                          sup_pts=np.zeros((0, max_support, 3)),
                          faces=np.zeros((0, MAX_FACES, 4)),
                          friction=np.zeros(0))
    return ActorTable(
        names=tuple(d.name for d in defs),
        mass=np.asarray([d.mass for d in defs], np.float32),
        inertia=np.stack([d.inertia for d in defs]).astype(np.float32),
        sup_pts=_pad_points([d.sup_pts for d in defs], max_support),
        # honor explicitly-provided face planes
        faces=np.stack([d.faces if d.faces is not None
                        else hull_faces(d.sup_pts, MAX_FACES)
                        for d in defs]),
        friction=np.asarray([d.friction for d in defs], np.float32),
    )


def link_collision_arrays(model: ArticulationModel, spec,
                          contact_links: Sequence[str],
                          max_support=MAX_SUPPORT):
    """(L, K, 3) support points + (L, F, 4) faces per link; links not in
    ``contact_links`` get a single far-away dummy point (they never touch)."""
    by_name = {l.name: l for l in spec.links}
    pts_list: List[np.ndarray] = []
    faces_list: List[np.ndarray] = []
    for name in model.link_names:
        link = by_name[name]
        if name in contact_links and link.collisions:
            parts = []
            for g in link.collisions:
                if g.points is not None:
                    parts.append(g.points)
                elif g.size is not None:
                    p = meshes.primitive_points(g.kind, g.size)
                    parts.append(p @ g.origin_rot.T + g.origin_pos)
            pts = np.concatenate(parts) if parts else np.zeros((1, 3))
            pts_list.append(pts)
            faces_list.append(hull_faces(pts, MAX_FACES))
        else:
            far = np.full((1, 3), 1e6, np.float32)
            pts_list.append(far)
            f = np.zeros((MAX_FACES, 4), np.float32)
            f[:, 2] = 1.0
            f[:, 3] = -1e9
            faces_list.append(f)
    return _pad_points(pts_list, max_support), np.stack(faces_list)


def make_scene(model: ArticulationModel, spec, actor_defs: Sequence[ActorDef],
               contact_links: Sequence[str] = (),
               link_friction: float = 1.0,
               planes: Optional[np.ndarray] = None,
               kp=1e3, kd=1e2, force_limit=100.0,
               sim_freq=120, control_freq=40,
               la_contact_actors: Optional[Sequence[str]] = None,
               solver: SolverParams = SolverParams(),
               device="cuda") -> PhysicsScene:
    """Assemble a PhysicsScene: robot + actors + tabletop plane, with
    contact pairs = (contact_links x actors) + all actor-actor pairs.  Its
    static arrays become tensors on ``device`` here, once (``device=None``
    leaves them to ``world.scene_tensors``)."""
    actors = build_actor_table(actor_defs)
    lpts, lfaces = link_collision_arrays(model, spec, contact_links)
    link_ids = [model.link_id(n) for n in contact_links]
    act_ids = (range(actors.num) if la_contact_actors is None
               else [actors.names.index(n) for n in la_contact_actors])
    la_pairs = np.asarray([(l, a) for l in link_ids for a in act_ids],
                          np.int32).reshape(-1, 2)
    aa_pairs = np.asarray([(i, j) for i in range(actors.num)
                           for j in range(i + 1, actors.num)],
                          np.int32).reshape(-1, 2)
    if planes is None:
        planes = np.asarray([[0.0, 0.0, 1.0, 0.0]], np.float32)  # table top
    nd = model.dof
    scene = PhysicsScene(
        model=model, actors=actors, planes=np.asarray(planes, np.float32),
        link_collision_pts=lpts, link_faces=lfaces,
        link_friction=np.full(model.num_links, link_friction, np.float32),
        la_pairs=la_pairs, aa_pairs=aa_pairs, solver=solver,
        kp=np.broadcast_to(np.asarray(kp, np.float32), (nd,)).copy(),
        kd=np.broadcast_to(np.asarray(kd, np.float32), (nd,)).copy(),
        force_limit=np.broadcast_to(np.asarray(force_limit, np.float32),
                                    (nd,)).copy(),
        sim_freq=sim_freq, control_freq=control_freq,
    )
    if device is None:
        return scene
    return dataclasses.replace(scene, tensors=scene_tensors(scene, device))
