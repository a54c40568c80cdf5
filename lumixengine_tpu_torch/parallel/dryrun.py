"""Multi-device dry run (counterpart of ``lumixengine_tpu/parallel/dryrun.py``;
≙ SURVEY.md §2.7/§2.8 scaling check).

Run as ``python -m lumixengine_tpu_torch.parallel.dryrun <n_devices>
[--device cpu|cuda]`` (the card unless ``--device cpu`` is given).

Body: build the full fused frame step (transforms, cull, animation, physics,
particles), make an ``n``-entry world mesh, shard a 2n-world batch over it
(pure data parallelism over the world axis, the engine's scaling design),
run ONE sharded step with donation and the summed global metric, and check
it against one unsharded step of the whole batch: frame counter 1,
``visible_total`` equal, world positions equal. On the CPU the mesh is n
copies of ``cpu`` and the positions must be equal bit for bit. On CUDA the
mesh is the host's cards, each repeated when there are fewer than n; the
gap in positions is printed and held to ``CARD_POS_ATOL``, since the card's
batched ops may pick other algorithms at another batch size.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

CARD_POS_ATOL = 1e-5   # metres; positions are O(100 m), one step at 1/60 s


def mesh_devices(n_devices: int, device="cuda"):
    """n mesh entries of `device`'s type: the host's cards in turn, each
    repeated when there are fewer than n; n copies of ``cpu`` on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dryrun: no CUDA device (pass --device cpu for the CPU)")
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def main(n_devices: int, device="cuda", out: Optional[dict] = None) -> int:
    """Run the dry run; with `out`, fill it with what was measured
    (``visible_total``, ``pos_gap``, ``devices``)."""
    from lumixengine_tpu_torch.models import demo_scenes
    from lumixengine_tpu_torch.parallel.mesh import (build_sharded_step, make_world_mesh,
                                                     replicate_state, shard_world_batch)

    devs = mesh_devices(n_devices, device)
    mesh = make_world_mesh(devices=devs)
    engine, world, *_ = demo_scenes.full_frame_world(
        num_entities=128, num_characters=4, num_bodies=8, particle_capacity=64)
    rmod = world.modules["renderer"]

    def make_step(d):
        return engine.build_step(world, d, extra=rmod.cull_pass)

    num_worlds = n_devices * 2
    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32)
    home = mesh[0]
    state = world.device_state(home)
    gen = torch.Generator(device=home).manual_seed(0)
    batched = replicate_state(state, num_worlds, generator=gen)

    # the unsharded oracle: one step of the whole batch on the first device
    oracle = make_step(home)(batched, dt.to(home))
    oracle_vis = int(oracle.modules["renderer"].counters["visible_count"].sum())

    shards = shard_world_batch(batched, mesh)
    stepv = build_sharded_step(make_step, mesh, donate=True, with_metrics=True)
    outs, metrics = stepv(shards, dt)

    frames = torch.cat([o.frame.reshape(-1).to(home) for o in outs])
    assert bool((frames == 1).all()), f"frame counters {frames.tolist()} != 1"
    vis_total = int(metrics["visible_total"])
    assert vis_total == oracle_vis, f"summed metric {vis_total} != oracle {oracle_vis}"
    pos = torch.cat([o.world.pos.to(home) for o in outs])
    gap = float((pos - oracle.world.pos).abs().max())
    if home.type == "cuda":
        assert gap <= CARD_POS_ATOL, f"sharded positions {gap} from the oracle (limit {CARD_POS_ATOL})"
    else:
        assert torch.equal(pos, oracle.world.pos), "sharded world positions diverge from the oracle"
    distinct = sorted({str(d) for d in mesh})
    repeated = (f", {len(distinct)} distinct device(s), each repeated"
                if len(distinct) < n_devices else "")
    print(f"dryrun ok: {n_devices} shards over {distinct}{repeated}, {num_worlds} worlds, "
          f"visible_total={vis_total}, position gap {gap:.3e}"
          + ("" if home.type == "cuda" else " (bitwise)"))
    if out is not None:
        out.update(visible_total=vis_total, pos_gap=gap, devices=[str(d) for d in mesh])
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1]
        del argv[i:i + 2]
    sys.exit(main(int(argv[0]) if argv else 8, dev))
