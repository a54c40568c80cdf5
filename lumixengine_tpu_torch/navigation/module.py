"""Navigation module (≙ reference src/navigation: Recast/Detour navmesh zones +
dtCrowd agents syncing entity transforms, navigation_module.cpp).

Reference: per-zone navmesh built by Recast from render geometry, dtCrowd
steering (path following + separation), agents move entities, .nav serialized
zones.

TPU re-architecture: a zone is a regular walkable GRID (the Recast voxel field
without the polygonization — on TPU the grid IS the fast representation):
  * walkable source: the reference's SHIPPED compiled navmeshes load directly
    (navzones/<guid>.nav → importers/navmesh.py Detour tile decode →
    rasterized polygons), with host physics-primitive baking as the
    no-navmesh fallback
  * pathfinding: host A* on the grid per set_destination request (the slow
    path, like Detour's findPath), producing capacity-bounded waypoint lists
  * steering: the device step moves ALL agents each frame — waypoint seeking
    + sampled velocity-obstacle avoidance (≙ dtCrowd's
    dtObstacleAvoidanceQuery::sampleVelocityAdaptive: head-on streams route
    around each other) + pairwise separation as the overlap resolver —
    dense O(A²) below 256 agents, x-sorted K-window O(A·K) above — and
    writes entity locals back
Zone serialization = the grid + params (".nav" analog).

The port's counterpart of ``lumixengine_tpu/navigation/module.py``: the zone,
the A* and the stores are the same host code; the step works on tensors with
an optional leading world axis, with the reference's stable x-sort
(``argsort(stable=True)``) and its scatter back to agent order. The shipped
navmesh import (``nav_zone`` with a guid) needs the host tier's importers and
raises ``NotImplementedError`` (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import heapq
from typing import Dict, Optional, Tuple

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.utils.store import DenseStore

MAX_WAYPOINTS = 32


@dataclass
class NavState:
    agent_pos: torch.Tensor     # f32 [3, A] (authoritative while navigating)
    agent_vel: torch.Tensor     # f32 [2, A] last chosen xz velocity (VO input)
    waypoints: torch.Tensor     # f32 [2, W, A] xz waypoints
    wp_count: torch.Tensor      # int32 [A]
    wp_index: torch.Tensor      # int32 [A] current target waypoint
    speed: torch.Tensor         # f32 [A] (data: scripts can change it)
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "NavState":
        return dataclasses.replace(self, **kw)


class NavZone:
    """Walkable grid zone (≙ NavmeshZone + RecastZone build)."""

    def __init__(self, origin=(0.0, 0.0), size=(64.0, 64.0), cell: float = 1.0):
        self.origin = np.asarray(origin, np.float32)  # xz of cell (0,0) corner
        self.cell = float(cell)
        self.w = int(round(size[0] / cell))
        self.h = int(round(size[1] / cell))
        self.walkable = np.ones((self.h, self.w), bool)
        self.guid = 0                 # reference navzone guid (.nav file)
        self.from_navmesh = False     # walkable came from a shipped .nav

    def to_cell(self, x: float, z: float) -> Tuple[int, int]:
        cx = int((x - self.origin[0]) / self.cell)
        cz = int((z - self.origin[1]) / self.cell)
        return max(0, min(self.w - 1, cx)), max(0, min(self.h - 1, cz))

    def to_world(self, cx: int, cz: int) -> Tuple[float, float]:
        return (self.origin[0] + (cx + 0.5) * self.cell,
                self.origin[1] + (cz + 0.5) * self.cell)

    def block_aabb(self, min_x, min_z, max_x, max_z) -> None:
        x0, z0 = self.to_cell(min_x, min_z)
        x1, z1 = self.to_cell(max_x, max_z)
        self.walkable[z0 : z1 + 1, x0 : x1 + 1] = False

    def bake_from_physics(self, physics_module, pad: float = 0.5) -> None:
        """Rasterize static actors into blocked cells (≙ Recast build from
        collision geometry)."""
        st = physics_module.actors
        for slot in range(st.capacity):
            e = int(st.entity[slot])
            if e < 0:
                continue
            if int(st.data["motion"][slot]) != 0:  # only statics block
                continue
            p, _, _ = physics_module.world.get_global_transform(e)
            if int(st.data["shape"][slot]) == 1:  # box
                he = st.data["half_extents"][slot]
                self.block_aabb(p[0] - he[0] - pad, p[2] - he[2] - pad,
                                p[0] + he[0] + pad, p[2] + he[2] + pad)
            else:
                r = float(st.data["radius"][slot]) + pad
                self.block_aabb(p[0] - r, p[2] - r, p[0] + r, p[2] + r)

    # -- A* (host path request, ≙ dtNavMeshQuery::findPath) ------------------------

    def find_path(self, start_xz, end_xz, max_waypoints: int = MAX_WAYPOINTS) -> Optional[np.ndarray]:
        s = self.to_cell(*start_xz)
        g = self.to_cell(*end_xz)
        if not self.walkable[g[1], g[0]] or not self.walkable[s[1], s[0]]:
            return None
        if s == g:
            return np.asarray([self.to_world(*g)], np.float32)
        # native A* core when built (≙ the reference's native Detour);
        # Python fallback below is semantically identical
        try:
            from lumixengine_tpu_torch.utils import native

            if native.available():
                cells = native.nav_astar(self.walkable, s[0], s[1], g[0], g[1])
                if cells is None:
                    return None
                return self._prune_cells([tuple(c) for c in cells], max_waypoints)
        except Exception:
            pass
        open_q = [(0.0, s)]
        came: Dict[Tuple[int, int], Tuple[int, int]] = {}
        cost = {s: 0.0}
        found = False
        while open_q:
            _, cur = heapq.heappop(open_q)
            if cur == g:
                found = True
                break
            cx, cz = cur
            for dx, dz, c in ((1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
                              (1, 1, 1.414), (1, -1, 1.414), (-1, 1, 1.414), (-1, -1, 1.414)):
                nx, nz = cx + dx, cz + dz
                if not (0 <= nx < self.w and 0 <= nz < self.h):
                    continue
                if not self.walkable[nz, nx]:
                    continue
                if dx and dz and not (self.walkable[cz, nx] and self.walkable[nz, cx]):
                    continue  # no corner cutting
                nc = cost[cur] + c
                if nc < cost.get((nx, nz), np.inf):
                    cost[(nx, nz)] = nc
                    h = np.hypot(nx - g[0], nz - g[1])
                    heapq.heappush(open_q, (nc + h, (nx, nz)))
                    came[(nx, nz)] = cur
        if not found:
            return None
        path = [g]
        while path[-1] != s:
            path.append(came[path[-1]])
        path.reverse()
        return self._prune_cells(path, max_waypoints)

    def _prune_cells(self, path, max_waypoints: int) -> np.ndarray:
        """String-pull-lite: drop collinear cells, resample long paths."""
        if len(path) == 1:
            return np.asarray([self.to_world(*path[0])], np.float32)
        pruned = [path[0]]
        for i in range(1, len(path) - 1):
            a, b, c = pruned[-1], path[i], path[i + 1]
            if (b[0] - a[0]) * (c[1] - b[1]) != (b[1] - a[1]) * (c[0] - b[0]):
                pruned.append(b)
        pruned.append(path[-1])
        if len(pruned) > max_waypoints:  # resample long paths
            idx = np.linspace(0, len(pruned) - 1, max_waypoints).astype(int)
            pruned = [pruned[i] for i in idx]
        return np.asarray([self.to_world(*c) for c in pruned], np.float32)

    def serialize(self) -> dict:
        return {"origin": self.origin.tolist(), "cell": self.cell,
                "walkable": np.packbits(self.walkable).tolist(),
                "shape": [self.h, self.w]}

    @staticmethod
    def deserialize(d: dict) -> "NavZone":
        z = NavZone(origin=d["origin"], size=(d["shape"][1] * d["cell"], d["shape"][0] * d["cell"]),
                    cell=d["cell"])
        z.walkable = np.unpackbits(
            np.asarray(d["walkable"], np.uint8), count=z.h * z.w
        ).reshape(z.h, z.w).astype(bool)
        return z


class NavigationModule(IModule):
    name = "navigation"
    COMPONENT_STORES = {"nav_agent": "agents"}

    def __init__(self, world: World, system: "NavigationSystem", max_agents: int = 256):
        super().__init__(world, system)
        self.agents = DenseStore(
            max_agents,
            {"radius": ((), np.float32, 0.5), "speed": ((), np.float32, 3.0)},
        )
        self.zone = NavZone()
        # separation regime switch: dense O(A²) below, x-sorted window above
        self.separation_window_threshold = 256
        self.separation_window = 24
        # local avoidance: "vo" = sampled velocity obstacles (≙ dtCrowd
        # dtObstacleAvoidanceQuery::sampleVelocity* — head-on streams route
        # around each other), "separation" = push-apart only (legacy)
        self.avoidance = "vo"
        # candidate steering angles (radians, relative to desired velocity);
        # each also sampled at half speed, plus a stop candidate
        self.vo_angles = (0.0, 0.45, -0.45, 0.95, -0.95, 1.6, -1.6)
        self.vo_horizon = 2.5        # seconds of look-ahead (≙ dtCrowd horizTime)
        self._pending_paths: Dict[int, np.ndarray] = {}
        self._statics = None
        self._statics_version = -1

    def component_types(self):
        return ["nav_agent", "nav_zone"]

    def create_component(self, entity: int, ctype: str, **props):
        if ctype == "nav_agent":
            self.agents.add(entity, radius=np.float32(props.get("radius", 0.5)),
                            speed=np.float32(props.get("speed", 3.0)))
            self._statics = None
        elif ctype == "nav_zone":
            self.zone = NavZone(origin=props.get("origin", (0.0, 0.0)),
                                size=props.get("size", (64.0, 64.0)),
                                cell=props.get("cell", 1.0))
            self.zone.guid = int(props.get("guid", 0))
            # the reference SHIPS compiled navmeshes (navzones/<guid>.nav,
            # ≙ NavigationModule::loadZone) — when one exists, its walkable
            # polygon set replaces the all-walkable default; the physics
            # re-bake at start_game then only ADDS obstacles on top
            if self.zone.guid:
                raise NotImplementedError(
                    f"nav_zone guid {self.zone.guid}: the shipped navmesh import needs the "
                    "host tier's importers (ROADMAP Queue 1 item 7)")
        else:
            raise KeyError(ctype)

    def destroy_component(self, entity: int, ctype: str) -> None:
        if ctype == "nav_agent":
            self.agents.remove(entity)
            self._statics = None

    def prepare_statics(self, device=None):
        self.world._refresh_levels()
        if self._statics is None or self._statics_version != self.world.topology_version:
            ents = self.agents.entity
            mask = ents >= 0
            act_cols = np.nonzero(mask)[0]
            self._statics = {
                "entity_slots": self.world.to_slots(ents),
                "mask": mask,
                "radius": np.asarray(self.agents.data["radius"], np.float32),
                "act_cols": act_cols,
                "device": {},
            }
            self._statics_version = self.world.topology_version
        if device is not None:
            self._device_statics(torch.device(device))

    def statics(self):
        self.prepare_statics()
        return self._statics

    def _device_statics(self, device) -> dict:
        """The statics as tensors on `device`, made once per topology."""
        st = self._statics
        key = str(device)
        if key not in st["device"]:
            a = st["mask"].shape[0]
            eye = torch.eye(a, dtype=torch.float32, device=device)
            st["device"][key] = {
                "mask": torch.as_tensor(st["mask"], device=device),
                "radius": torch.as_tensor(st["radius"], device=device),
                "eye9": eye * 1e9,
                "not_eye": ~eye.bool(),
                "act_cols": torch.as_tensor(st["act_cols"], dtype=torch.int64, device=device),
                "act_slots": torch.as_tensor(st["entity_slots"][st["act_cols"]],
                                             dtype=torch.int64, device=device),
                "vo_cos": torch.as_tensor(np.cos(self.vo_angles).astype(np.float32),
                                          device=device),
                "vo_sin": torch.as_tensor(np.sin(self.vo_angles).astype(np.float32),
                                          device=device),
                "vo_dev2": torch.as_tensor(self._vo_dev2(), device=device),
            }
        return st["device"][key]

    # -- host path API (≙ NavigationModule::navigate) ------------------------------

    def set_destination(self, state: WorldState, entity: int, target_xz) -> WorldState:
        """Plan a path (host A*) from the agent's position (world 0's, of a
        batch) and install it into the device state of every world."""
        slot = self.agents.slot_of(entity)
        ns: NavState = state.modules[self.name]
        pos = ns.agent_pos[..., :, slot].detach().cpu().numpy().reshape(-1, 3)[0]
        path = self.zone.find_path((float(pos[0]), float(pos[2])), tuple(target_xz))
        if path is None:
            return state
        wp = np.zeros((2, MAX_WAYPOINTS), np.float32)
        wp[:, : len(path)] = path.T
        waypoints, wp_count, wp_index = ns.waypoints.clone(), ns.wp_count.clone(), ns.wp_index.clone()
        waypoints[..., :, :, slot] = torch.as_tensor(wp, device=waypoints.device)
        wp_count[..., slot] = len(path)
        wp_index[..., slot] = 0
        ns = ns.replace(waypoints=waypoints, wp_count=wp_count, wp_index=wp_index)
        return state.replace(modules={**state.modules, self.name: ns})

    # -- device state ---------------------------------------------------------------

    def device_state(self, device) -> NavState:
        a = self.agents.capacity
        pos = np.zeros((3, a), np.float32)
        for slot in range(a):
            e = int(self.agents.entity[slot])
            if e >= 0:
                pos[:, slot] = self.world.get_global_transform(e)[0]
        f32 = dict(dtype=torch.float32, device=device)
        return NavState(
            agent_pos=torch.as_tensor(pos, device=device),
            agent_vel=torch.zeros((2, a), **f32),
            waypoints=torch.zeros((2, MAX_WAYPOINTS, a), **f32),
            wp_count=torch.zeros(a, dtype=torch.int32, device=device),
            wp_index=torch.zeros(a, dtype=torch.int32, device=device),
            speed=torch.as_tensor(self.agents.data["speed"], device=device),
            counters={"navigating": torch.zeros((), dtype=torch.int32, device=device)},
        )

    @staticmethod
    def _x_order(pos_xz, mask):
        """Stable x-sort of the agents, dead ones last (as jnp.argsort)."""
        return torch.argsort(torch.where(mask, pos_xz[..., 0, :], 1e9), dim=-1, stable=True)

    @staticmethod
    def _take(x, ordx):
        """x [..., C, A] in the order ordx [..., A] (jnp.take along -1)."""
        return torch.gather(x, -1, ordx[..., None, :].expand(x.shape))

    @staticmethod
    def _untake(xs, ordx):
        """Scatter xs [..., C, A] (sorted) back to agent order:
        zeros.at[..., ordx].set(xs)."""
        return torch.zeros_like(xs).scatter(-1, ordx[..., None, :].expand(xs.shape), xs)

    def _separation(self, d, pos_xz, mask):
        """dtCrowd local-avoidance push. Two regimes (≙ dtCrowd's
        proximity-grid queries): dense O(A²) pairwise up to
        `separation_window_threshold` agents, and an x-sorted WINDOW pass
        above it — each agent interacts with its K nearest x-neighbors
        (O(A·K)), the same trick as the physics SAP broadphase."""
        rr = d["radius"]
        a_cap = pos_xz.shape[-1]
        if a_cap <= self.separation_window_threshold:
            dd = pos_xz[..., :, None, :] - pos_xz[..., :, :, None]    # [.., 2, A, A]
            d2 = torch.sum(dd * dd, dim=-3) + d["eye9"]
            min_d = rr[None, :] + rr[:, None]
            push_w = torch.clamp_min(min_d * min_d * 2.25 - d2, 0.0) / (min_d * min_d * 2.25)
            push_w = push_w * (mask[None, :] & mask[:, None])
            inv_d = torch.rsqrt(torch.clamp_min(d2, 1e-9))
            return -torch.sum(dd * (push_w * inv_d)[..., None, :, :], dim=-1)

        k = self.separation_window
        ordx = self._x_order(pos_xz, mask)
        sp = self._take(pos_xz, ordx)                                  # [.., 2, A]
        sr = rr[ordx]
        sm = mask[ordx]
        sep_s = torch.zeros_like(sp)
        for off in range(1, k + 1):
            n = a_cap - off
            dd = sp[..., :, off:] - sp[..., :, :n]                     # [.., 2, A-off]
            d2 = torch.sum(dd * dd, dim=-2)
            min_d = sr[..., :n] + sr[..., off:]
            w = torch.clamp_min(min_d * min_d * 2.25 - d2, 0.0) / (min_d * min_d * 2.25)
            w = w * (sm[..., :n] & sm[..., off:])
            push = dd * (w * torch.rsqrt(torch.clamp_min(d2, 1e-9)))[..., None, :]
            sep_s[..., :, :n] += -push
            sep_s[..., :, off:] += push
        return self._untake(sep_s, ordx)

    def _vo_dev2(self) -> np.ndarray:
        """|s·R(θ)·u − u|² for a unit u, per candidate (full speed, half
        speed, stop), from |θ|: mirrored candidates get equal values."""
        th = np.abs(np.asarray(self.vo_angles, np.float64))
        full, half = 2.0 - 2.0 * np.cos(th), 1.25 - np.cos(th)
        return np.concatenate([full, half, [1.0]]).astype(np.float32)

    def _vo_candidates(self, d, des):
        """Candidate velocity set: the desired velocity rotated by the fixed
        vo_angles at full and half speed, plus a stop sample → [.., S, 2, A]."""
        ca, sa = d["vo_cos"], d["vo_sin"]
        dx, dz = des[..., 0, :], des[..., 1, :]
        rx = ca[:, None] * dx[..., None, :] - sa[:, None] * dz[..., None, :]
        rz = sa[:, None] * dx[..., None, :] + ca[:, None] * dz[..., None, :]
        full = torch.stack([rx, rz], dim=-2)                           # [.., S0, 2, A]
        return torch.cat([full, 0.5 * full, torch.zeros_like(full[..., :1, :, :])], dim=-3)

    @staticmethod
    def _ttc(d, rv, rad):
        """Time to collision of a relative circle (radius `rad`, separation
        `d`, closing velocity `rv`): smallest t ≥ 0 with |d - rv·t| = rad,
        +inf when diverging / missing, 0 when already overlapping."""
        a = torch.sum(rv * rv, dim=-2)
        b = torch.sum(d * rv, dim=-2)                                  # >0 ⇒ closing
        c = torch.sum(d * d, dim=-2) - rad * rad
        disc = b * b - a * c
        hit = (disc >= 0.0) & (b > 0.0)
        t = (b - torch.sqrt(torch.clamp_min(disc, 0.0))) / torch.clamp_min(a, 1e-9)
        return torch.where(c <= 0.0, 0.0, torch.where(hit & (t >= 0.0), t, torch.inf))

    def _sample_velocity(self, d, pos_xz, des, nvel, mask):
        """Sampled velocity-obstacle avoidance (≙ dtObstacleAvoidanceQuery::
        sampleVelocityAdaptive driven from dtCrowd::update): the cheapest
        candidate of `_vo_cost` wins, the first of equals."""
        cands, cost = self._vo_cost(d, pos_xz, des, nvel, mask)
        best = torch.argmin(cost, dim=-2)                              # [.., A]
        chosen = torch.gather(cands, -3, best[..., None, None, :].expand(
            cands.shape[:-3] + (1,) + cands.shape[-2:]))[..., 0, :, :]
        return torch.where(mask[..., None, :], chosen, des)

    def _vo_cost(self, d, pos_xz, des, nvel, mask):
        """(candidates [.., S, 2, A], cost [.., S, A]): every candidate
        velocity scored by deviation from the desired velocity plus an
        inverse time-to-collision penalty against neighbor agents (circles
        moving at their last chosen velocity). Dense O(S·A²) up to the
        window threshold, x-sorted K-window O(S·A·K) above — as in
        _separation.

        The deviation |s·R(θ)·des − des| is taken as |des|·sqrt(s² − 2s·cos|θ|
        + 1) (``vo_dev2``), the same value up to rounding as the reference's
        sqrt(sum((cand − des)²)), but equal for the candidates mirrored about
        the desired velocity: where their penalties are equal too, the
        costs tie exactly and the first candidate in ``vo_angles`` order
        wins on every device. With the reference's form the pick at such a
        tie follows the rounding of the candidates' products, and the
        reference's own eager and jitted steps part there."""
        rr = d["radius"]
        a_cap = pos_xz.shape[-1]
        cands = self._vo_candidates(d, des)                            # [.., S, 2, A]
        horizon = self.vo_horizon
        w_vel, w_toi = 0.15, 1.0

        dev = torch.sqrt(torch.clamp_min(
            torch.sum(des * des, dim=-2)[..., None, :] * d["vo_dev2"][:, None], 1e-12))

        if a_cap <= self.separation_window_threshold:
            # layout [.., S, Ai, 2, Aj] so _ttc's component axis stays at -2
            dd = (pos_xz[..., None, :, :]
                  - pos_xz.transpose(-1, -2)[..., :, :, None])         # [.., Ai, 2, Aj]
            rv = (cands.transpose(-1, -2)[..., :, :, None]
                  - nvel[..., None, None, :, :])                       # [.., S, Ai, 2, Aj]
            rad = rr[None, :] + rr[:, None] + 0.05                     # [Ai, Aj]
            t = self._ttc(dd[..., None, :, :, :], rv, rad)             # [.., S, Ai, Aj]
            valid = mask[None, :] & mask[:, None] & d["not_eye"]
            t = torch.where(valid, t, torch.inf)
            tmin = torch.amin(t, dim=-1)                               # [.., S, A]
        else:
            k = self.separation_window
            ordx = self._x_order(pos_xz, mask)
            sp = self._take(pos_xz, ordx)
            sr = rr[ordx]
            sm = mask[ordx]
            sv = self._take(nvel, ordx)
            sc = torch.gather(cands, -1, ordx[..., None, None, :].expand(cands.shape))
            tmin_s = torch.full(sc.shape[:-2] + (a_cap,), torch.inf, device=sc.device)
            for off in range(1, k + 1):
                n = a_cap - off
                dd = sp[..., :, off:] - sp[..., :, :n]                 # [.., 2, A-off]
                rad = (sr[..., :n] + sr[..., off:] + 0.05)[..., None, :]
                pair_ok = (sm[..., :n] & sm[..., off:])[..., None, :]
                # i's candidates vs neighbor i+off's current velocity
                rv_a = sc[..., :, :, :n] - sv[..., None, :, off:]
                t_a = torch.where(pair_ok, self._ttc(dd[..., None, :, :], rv_a, rad), torch.inf)
                tmin_s[..., :, :n] = torch.minimum(tmin_s[..., :, :n], t_a)
                # (i+off)'s candidates vs neighbor i's current velocity
                rv_b = sc[..., :, :, off:] - sv[..., None, :, :n]
                t_b = torch.where(pair_ok, self._ttc((-dd)[..., None, :, :], rv_b, rad), torch.inf)
                tmin_s[..., :, off:] = torch.minimum(tmin_s[..., :, off:], t_b)
            tmin = self._untake(tmin_s, ordx)

        pen = torch.where(tmin < horizon, w_toi * (1.0 - tmin / horizon), 0.0)
        return cands, w_vel * dev + pen                                # [.., S, A]

    def _steering(self, d, ns: NavState):
        """(navigating, wp_index, pos_xz, desired velocity) of this frame."""
        mask = d["mask"]
        navigating = mask & (ns.wp_index < ns.wp_count)
        # current waypoint (xz)
        wi = torch.clamp(ns.wp_index, 0, MAX_WAYPOINTS - 1).long()
        tgt = torch.gather(ns.waypoints, -2, wi[..., None, None, :].expand(
            ns.waypoints.shape[:-2] + (1,) + ns.waypoints.shape[-1:]))[..., 0, :]  # [.., 2, A]
        pos_xz = torch.stack([ns.agent_pos[..., 0, :], ns.agent_pos[..., 2, :]], dim=-2)
        to_wp = tgt - pos_xz
        dist = torch.sqrt(torch.clamp_min(torch.sum(to_wp * to_wp, dim=-2), 1e-12))
        reached = dist < 0.3
        wp_index = torch.where(navigating & reached, ns.wp_index + 1, ns.wp_index)
        seek = to_wp / dist[..., None, :]
        des = seek * torch.where(navigating, ns.speed, 0.0)[..., None, :]
        return navigating, wp_index, pos_xz, des

    # -- phases (≙ navigation_module.cpp update: dtCrowd step) -----------------------

    def update(self, state: WorldState, dt) -> WorldState:
        ns: NavState = state.modules[self.name]
        self.prepare_statics()
        d = self._device_statics(ns.agent_pos.device)
        mask = d["mask"]
        navigating, wp_index, pos_xz, des = self._steering(d, ns)
        if d["act_cols"].numel():
            sep = self._separation(d, pos_xz, mask)
            if self.avoidance == "vo":
                # sampled velocity obstacles steer AROUND predicted collisions
                # (≙ dtCrowd's obstacle avoidance); separation stays on as the
                # overlap resolver of last resort
                chosen = self._sample_velocity(d, pos_xz, des, ns.agent_vel, mask)
            else:
                chosen = des
            vel = chosen + sep * 2.0
        else:
            # an empty store: every pair is masked, so separation and the VO
            # pick add nothing (chosen = des) and nothing moves; skipping
            # them spares the dense [S, A, 2, A] pass over empty slots
            chosen = vel = des
        new_xz = pos_xz + vel * dt
        agent_pos = torch.stack([torch.where(mask, new_xz[..., 0, :], ns.agent_pos[..., 0, :]),
                                 ns.agent_pos[..., 1, :],
                                 torch.where(mask, new_xz[..., 1, :], ns.agent_pos[..., 2, :])],
                                dim=-2)

        # write agents back into entity locals (≙ dtCrowd agents sync transforms)
        if d["act_cols"].numel():
            local = state.local.replace(pos=state.local.pos.index_copy(
                -1, d["act_slots"], agent_pos.index_select(-1, d["act_cols"])))
            state = state.replace(local=local)

        ns = ns.replace(
            agent_pos=agent_pos, wp_index=wp_index, agent_vel=chosen,
            counters={"navigating": torch.sum(navigating, dim=-1, dtype=torch.int32)},
        )
        return state.replace(modules={**state.modules, self.name: ns})


class NavigationSystem(ISystem):
    name = "navigation_system"

    def create_modules(self, world: World) -> NavigationModule:
        caps = getattr(self.engine, "module_capacities", {})
        return NavigationModule(world, self, max_agents=caps.get("nav_agents", 256))
