#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the hand-written kernels (nvcc, sm_90a) from lumixengine_tpu_torch/csrc,
     with what ptxas reports for each kernel (registers, shared memory, spills;
     the Threefry kernels and BG, the banded grids kernel, must spill nothing);
  3. K1 (frustum cull) against its plain PyTorch version on the cull pass's
     own operands at [1024, 10240]: bit for bit;
  4. K2 (fused contact solve) against its plain version on the contact sets
     of the slice world settled at W=1024 (NB=64, C=1792, 10 + 3 iterations),
     as a pile, and on the largest shape the module makes,
     full_frame_world(2048, 0, 256, 0) piled at W=1024 (NB=256, C=7168),
     within solver.K2_PLAIN_ATOL; the plain version run one iteration or one
     projection pass short must exceed that limit;
  5. the main paths, each through Engine.build_step(extra=cull_pass) on the
     card with the launch counts set to 0 just before and read just after:
     the full flagship full_frame_world(10240, 64, 64, 2048) replicated to
     1024 worlds for FRAMES frames (hierarchy, 32 animables, 32 locomotion
     animators with root motion and dual-quaternion palettes, 64 rigid
     bodies, the 2048-particle storm emitter, the cull pass); the slice
     full_frame_world(10240, 0, 64, 0) at 256 worlds (a smaller W than the
     flagship's, to fit the script's time); the skinned crowd
     skinned_crowd_world(256) (128 animables, 128 locomotion animators, no
     physics) at CROWD_WORLDS worlds; the 1M-particle storm
     particle_stress_world(1_000_000) at 1 world. Each kernel of a path
     launches once per frame (K2 only where there is physics; on the storm
     K1 launches on the world's 8 empty model-instance slots and culls
     nothing, as in the reference), and the Threefry kernel at least once a
     frame where there are particle emitters and never where there are
     none; the state stays finite; every character
     is animated, 0 < particles alive <= capacity, root motion moves the
     animators. K1 is then held bit for bit to its plain version on the
     operands the path's own cull pass gives it, at the path's W and K (the
     world camera and a random view per world). Then 3 frames at W=4 on the
     card against the plain versions
     on the CPU, animation and particle fields included (the storm's end
     state tiled to 4 worlds that diverge), and the threefry stream on the
     card against the CPU's, bit for bit (a draw under a twice-folded key,
     and fold_uniform, the particles' draw, at [1024, 2048] against its
     plain version on the card too). Two paths of the RenderModule's
     views follow: the headless demo tick headless_demo_world(2048) at
     W=4096 (BASELINE config 1, bench.py --config demo), and the render
     config, the full flagship at W=1024 with each frame followed by
     shadow_pass (4 cascades, LIGHT_DIR) and fill_clusters on every world
     (bench.py --config render), their caster counts, cluster counts and
     overflow summed and read. After the timed frames, one prepare_view in
     each sort mode (K1 once a call) with its draw order checked, and
     record_frame on world 0; the torch ops of prepare_view, the shadow pass
     and the cluster pass; the cluster pass timed against its bound (on
     both paths; the bound counts the live lights only). Each
     path's 3-frame compare also holds prepare_view (both sort modes), the
     caster masks and the cluster words, lists, counts and overflow to the
     CPU's outside their margins (the port's pipeline.DEPTH_EPS,
     shadows.SHADOW_MARGIN and clusters.CLUSTER_D2_EPS). Then a small crowd
     with two bone attachments, K1 against plain on its operands, 3 frames
     card vs CPU, each attachment at its bone's pose;
  6. the 10k-box drop box_drop_pile(10_000) (the slot pipeline, no
     hand-written kernel) as the reference's bench.py --config boxes
     --steps 600 --trials 1 runs it: 600 steps to warm up, then 600 timed
     steps, the state carried through, the slot_drop and column_miss
     certificates summed on the card over all 1200: both 0, the state
     finite, kinetic energy (sum of |v|^2 + |w|^2) below 50 and more than
     90% of the boxes asleep at step 1200 (the reference's recorded end
     state on its TPU: 0.0 and 9887), every sleeping box's centre above
     BOX_SLEEP_Y_MIN; the reference's 10^3-box test bounds the lowest
     centre by 0.47 m, which a 22-level pile breaks (an awake box under
     sleeping ones sinks, in the reference too, PERF.md), so at most
     BOX_BELOW_MAX boxes lie below 0.47 m and none below BOX_LOWEST_MIN,
     bounds set from the card's and the reference's readings; then 3 steps
     from the card's state at step 60 (mid-impact) on the card against the
     CPU, within BODY_POS_ATOL / BODY_VEL_ATOL with equal certificates;
     then BJ, the banded Jacobi kernel, on the 10k-box drop's own operands
     (box_drop_world at BJ_WORLDS worlds after BJ_LAND_FRAMES frames through
     the engine's step, the PhysicsModule's banded branch): within
     BJ_PLAIN_ATOL of its plain version, inactive slots' lambdas 0, two
     calls bit-identical, its launches in each stepped frame, its ms over
     BJ_REPS calls with CUDA events beside the plain version's and its bound
     (physics_banded.banded_jacobi_bytes); then BG, the banded contact stage's
     kernel, on the same frame's stage operands: every flag equal to the
     plain version's except within BG_DEPTH_TIE of depth 0, active slots
     within BG_PLAIN_ATOL, friction, restitution, warm-start lambdas, ground
     grids and the certificate exact, two calls bit-identical, one launch a
     sweep in each stepped frame, its ms over BJ_REPS calls beside the plain
     version's and its bound (physics_banded.banded_grids_bytes);
  7. the PhysicsModule beyond the flagship, each path with the launch counts
     set to 0 just before it and read just after: the nine committed
     goldens (tests/data/golden_*.npz) at W=1 for their full step counts,
     each held to the bounds of the JAX package's
     tests/test_golden_trajectories.py (capsule_stack, whose outcome
     rounding decides, as an ensemble of 64 starts held to the JAX
     package's count of worlds within the bounds), K2 launching once a
     step wherever there is a contact stream and held to its plain version
     on each world's last contact set; a world farm: hinge_pendulum and
     capsule_stack each replicated to 4096 diverging worlds for FARM_FRAMES frames
     (ms/frame, body-steps/s of the dynamic bodies, torch ops per frame, K2
     on the farm's contact set against plain, timed and against its bound);
     the banded branch, which `auto` picks above 256 actor slots: a
     10,000-box block on the bench's grid at 10,240 slots (sweep window 40),
     BANDED_STEPS steps at W=1
     (ms/step, the window certificate summed on the card: 0, finite, the
     lowest box centre), then a 1,000-box block 90 steps in, 3 steps on the
     card against the CPU; and ballistic and d6_slider on the card and on
     the CPU side by side for the first GAP_STEPS steps of their arcs: each
     physics field's largest gap, the first step past GAP_LIMIT, and the
     first torch op whose
     outputs differ (first_divergent_op); then the game content of
     models/physics_scenes.py: the props farm (hulls on boxes and hulls,
     SDF mesh colliders, CCD spheres at a thin slab and head-on, instanced
     cubes and hulls; W=4096), the drive farm (a four-wheel vehicle under
     throttle and steer, a walking character controller, 64 rays and 64
     sphere sweeps a world each frame; W=4096) and the terrain farm (a
     seeded 64 x 64 heightfield, dropped bodies, a walking controller;
     W=1024), each for its JAX tests' settle time with world 0 as built and
     the others perturbed: ms/frame, body-steps/s, torch ops a frame, K2
     launching once a frame and held to its plain version on the farm's
     end contact set (timed, against its bound), the scene's physical checks
     on every world (resting heights, no tunnelling through the thin mesh,
     the vehicle moving forward and turning, the controller grounded), the
     device time of the new layers (polytope SAT, SDF streams, CCD,
     heightfield, vehicles, queries) and 3 frames card vs CPU; and the
     banded props level, 1,024 random hulls in the JAX pile test's stacks
     of five over an SDF slab and the ground at 1,024 actor slots (`auto`
     picks the banded branch), BANDED_PROPS_STEPS_CUT (30) steps at W=1
     with every step's window certificate printed and that test's settle
     readings hull by hull (the bounds, at most BANDED_PROPS_UNSETTLED hulls
     outside them, are held after the full 360 steps by tools/sim_tier.py
     --only props), and 3 steps card vs CPU on 4 of its stacks;
  9. the full engine (each path with the launch counts set to 0 just
     before it and read just after): the scripts config, bench.py --config
     scripts, script_stress_world(64) at W=4096 (every mover's Lua update()
     compiled to the device fast path, all 64 or the script fails; the rows
     on the card; 60 frames with the cull pass, K1 held to plain on its
     operands, 3 frames card vs CPU); the game world of
     models/game_scenes.py through Runner.tick at W=1 for 520 frames (the
     head-on agent streams, a compiled and a host script, nested GUI
     anchors and a button whose click runs a script through a core signal,
     a 3D sound in an echo zone, a spline) held to the JAX tests' gates
     (closest agents above 0.5 m, everyone arrives, the ping-pong inside
     +-0.55, the host script ran, one click fires the signal once); and the
     same world's device modules with 2 x 512 crossing agents (the window
     regime) at W=256, 60 frames timed, 3 frames card vs CPU; for the
     scripts config and the width path, one frame's and one module's time
     on CUDA events beside their kernels' device time (torch.profiler): the
     frame's device-busy share;
  10. the simulation tier (each path with the launch counts set to 0 just
     before it and read just after; tools/sim_tier.py runs it alone): the
     sap pile, physics_scenes.mixed_pile(2048) under broadphase="sap" at
     W=16 for 120 steps (ms/step, body-steps/s, ops/step, sap_window_miss
     summed: 0, the JAX test's settle gates on every world, the step's
     device-busy share, 3 frames card vs CPU at W=4); make_big_world_step and make_banded_world_step (4
     sweeps, warm start) on the elongated 4,096-box pile of
     tests/test_parity.py::test_box_drop_statistics at its settings for
     40 steps (20 falling, PILE_SETTLE_STEPS_CUT settling; the free-fall
     gate, certificates summed: 0, exact_window_miss of the banded end
     state: 0, 3 steps card vs CPU at W=2 on a 512-box pile; the settle
     gates after the full 320 steps in tools/sim_tier.py), make_banded_world_step on box_drop_pile(10_000) at window 40
     for 40 steps (certificate and exact_window_miss: 0); the banded farm,
     mixed_pile(512) under `auto` at W=1 and W=64 for 20 steps (60 alone; ops/step
     equal within 2% across the widths, certificate 0, the blow-up gates,
     3 frames card vs CPU); the layered crowd, demo_scenes.layered_crowd_world(128) at
     W=1024 for 30 frames with the cull pass (K1 once a frame and bit for
     bit to plain on its operands, every reachable IK effector within 0.05
     m of its target, every animated light and platform row np.interp of
     its curve within 1e-6, 3 frames card vs CPU). None of these paths
     launches K2 (the large-world branches bypass it, as in the reference);
  11. render and present (printed before phase 8's timings): app.main's
     path, headless_demo_world(2048) through the Runner (start, 60 ticks
     with the cull pass, K1 once a tick and bit for bit to plain on the
     path's operands), then present() with the builtin plugins at 480x270
     (host raster, the passes on the card) and present_tpu() at 480x270 and
     1280x720 (the tile raster, decals, clustered lights and splats on the
     card): ms a present on CUDA events (median and spread), torch ops a
     present, overflow, the raster's device time against the passes', one
     present with every synchronizing CUDA call an error, two presents on
     one state byte-identical, and the card against the CPU from one state
     (present_tpu: equal overflow, hit masks on 99.9% of the pixels, depth
     within 1e-5 relative, rgb within 1 level on 99.9%; present(): within
     2 u8 levels);
  12. load and save (printed before phase 8's timings; alone: tools/host_tier.py):
     the stress scene of models/host_scenes.py (2,048 entities in a
     three-level hierarchy, 64 dynamic bodies over a static slab, lights, a
     camera, animables, a nav zone on a packed .nav with agents, GUI rects
     with a core signal, sounds, 8 Lua scripts, one spawning a model
     instance) written as a .unv and loaded with Runner.load_world on the
     card: load and start on the host's clock, 60 ticks (K1 and K2 once a
     tick), the metrics(phases=True) model beside each phase's device time,
     the same load and 3 ticks on the CPU against the card (state_gap,
     explain_break), the world blob (codec lz4n) loaded into a fresh engine
     to the same snapshot and 10 steps of both field by field, a
     checkpoint at tick 30 resumed bit for bit, export_scene back to the
     scene, K2 on the path's contact set;
  13. real assets and the terminal (printed before phase 8's timings;
     alone: tools/asset_tier.py): the assets of models/asset_scenes.py (a
     skinned FBX character at the size of the reference's "Y bot", 52
     bones, with a 1 s take; an FBX box, sphere and rock with .fbx.meta
     sidecars; a .mat; an .ltc graph; the take as an .anm) and phase 12's
     stress scene on them, written as a .unv; each FBX parsed on the host's
     clock; the rock with its .meta (convex hull), the .anm, the .mat and
     the .ltc compiled through the AssetCompiler attached to the engine, a
     rewritten .mat recompiled by one Engine.update_host; Runner.load_world
     on the card with every FBX path a real model and the take a real clip
     (no placeholder), the .anm's clip bound to an animable; 60 ticks (K1
     and K2 once a tick) and the frame's device-busy share; the same load
     and 3 ticks on the CPU against the card (poses and palettes
     included); present_tpu at 480x270 from the scene's camera and from a
     close view of a character, the close view card vs CPU; the game
     view's play, 30 tick_frames and stop, the restored snapshot bit for
     bit outside what a blob does not carry; the animation graph editor's
     preview on an .act of the take, the particle editor's preview on the
     card and on the CPU (equal live counts), the voxelizer on the
     character; app.main --world --tui with its output in a buffer, on the
     card; K2 on the path's contact set;
  14. the editor (printed before phase 8's timings; alone: tools/editor_tier.py):
     phase 12's stress scene written as a .unv beside the assets of phase
     13 and opened by EditorApp on the card as `python -m
     lumixengine_tpu_torch.editor.app --world` opens it; a fixed key
     script through EditorApp.handle_key (a transform and a reflected
     property edited, an entity created and destroyed, each undone and
     redone; the log, asset browser, model-meta, profiler, scene, physics,
     material, settings and spline views and the docked panes; the scene
     view's frames at 160x90 paused (the dt = 0 step) and playing, before
     and after a layer edit in the physics view) with the launch counts set
     to 0 just before and read just after; ms a render_text, a scene view
     frame, a command, an undo and a redo, on the host's clock; the same
     script on the CPU: equal screens and host rows, the paused images
     within 2 u8 levels, the scene view's states within phase 12's
     tolerances; the world saved as .unv and reloaded (export equal); K1
     and K2 against their plain versions on the path's operands once the
     bodies rest; parallel/dryrun.py with 2 shards on the card (the card
     repeated on one card), its summed visible_total equal to the unsharded
     step's and its position gap;
  15. the JAX package's last surface (printed before phase 8's timings; alone:
     tools/surface_tier.py): the flagship at 1024 worlds, its bodies piled,
     SURFACE_FRAMES frames under each PhysicsModule solver_backend (auto and
     pallas launch K2 once a frame, jnp runs the reference's jnp solve and
     projection and launches it never), ms a frame, the jnp state's gap to
     auto after the first frame (within SURFACE_JNP_ATOL) and after the
     last (unbounded: the solves sum in other orders and the jnp projection
     caps its push), K2 against its plain version on the phase's operands;
     the slot step's classic tier (one sweep, no warm start, no mass
     splitting, no sleeping, all four) for SURFACE_BOX_STEPS steps each from
     the 10k-box drop's step-1200 state, every body finite and above the
     ground, the certificates printed; propagate, propagate_indexed and
     (on a uniform-scale hierarchy) propagate_doubling on the flagship's
     hierarchy in entity order against propagate_plan; culling_system.cull
     on the flagship's culled entities (K1 bit for bit with its plain
     version); blend_palette and skin_points on the ybot-size character
     over 16 animators against the host's formula; a flagship step with the
     floating-point traps on, then one on a NaN velocity, which must raise
     FloatingPointError naming the field;
  16. the JAX classes' last members (printed before phase 8's timings; alone:
     tools/members_tier.py): headless_demo_world(2048) at 1024 worlds, every
     model instance re-pointed through the reflection registry after one
     frame, 3 frames card against the CPU on 2 worlds (mi_lod, mi_visible,
     mi_model equal in every slot; the view statics equal statics built
     anew), RenderModule.set_model's model and cull radius; the flagship at
     1024 worlds, its bodies piled, its animables' clip and time_scale and
     its animators' controller set through the registry and one input
     through set_animator_input, 3 frames card against the CPU (poses and
     palettes within POSE_ATOL; the groups read the new time scales); ms a
     frame with build_palettes on and off (median and spread of CUDA
     events), the palette untouched with it off; K1 and K2 against their
     plain versions on the phase's operands, with their launches;
  8. timings with CUDA events: ms/frame and entity-steps/s of each path
     (demo and render included), the cluster pass against its bound
     (particle-steps/s of the storm, as bench.py counts it), body-steps/s
     of the boxes, of the farms, the game farms and the banded blocks, each kernel beside
     its plain version (plain, kernel, kernel, plain; K2 on the settled and
     the piled problem; the Threefry kernel as fold_uniform at [4096, 2048],
     the flagship cell's draw) and against its bound: the bytes it must move
     over 3.35 TB/s or its operations over 67 TFLOP/s (fp32; for the Threefry
     kernel its integer ALU-pipe operations over 1.67e13/s), whichever is
     longer; each kernel's launches on every path in the kernels' record;
     and the torch ops dispatched per frame or step.

Any failure raises and the exit code is not 0. The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}. Without a CUDA device
the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_ENTITIES, N_CHARACTERS, N_BODIES, N_PARTICLES = 10240, 64, 64, 2048
# the main paths' depth: 50 frames (100 before the game content joined the script); the
# flagship's bodies land after about 40
WORLDS, FRAMES, WARM_FRAMES, SETTLE_FRAMES = 1024, 50, 10, 240
SLICE_WORLDS = 256       # the slice path (no characters, a 1-slot emitter), at a smaller depth
CROWD_CHARACTERS, CROWD_WORLDS = 256, 1024
STORM_CAPACITY = 1_000_000
N_BOXES, BOX_STEPS, BOX_COMPARE_AT = 10_000, 600, 60  # bench.py: a warm run, then the timed one
BOX_KE_MAX, BOX_ASLEEP_MIN = 50.0, 0.9   # the reference's settle gate (its 10^3 CI test)
BOX_Y_MIN = 0.47         # that test's bound on the lowest box centre; see run_boxes
# At step 1200 awake boxes under sleeping ones sit below BOX_Y_MIN and sink (the reference
# does the same, PERF.md): the card reads 27 such boxes, the lowest at 0.2456 m and sinking
# 1.58e-4 m per step; the JAX package on the CPU reads 20. Held to these readings:
BOX_BELOW_MAX = 30       # boxes whose centre is below BOX_Y_MIN
BOX_LOWEST_MIN = 0.2     # the lowest centre of any box
# a box falls asleep only after its ground depth read at most 8 slop (4 cm) at the start of
# the frame before, and that frame's position pass moves it at most max_correction (4 cm)
# more: a sleeping box's centre stays above 0.5 - 0.08, less a centimetre for its velocity
BOX_SLEEP_Y_MIN = 0.41
# bench.py's recorded TPU run: its end state follows the warm run and the timed one, step 1200
BOX_REFERENCE_END = {"ke_end": 0.0, "sleeping_end": 9887}
# the PhysicsModule beyond the flagship: the goldens at W=1, two of them as a world farm,
# and a block of boxes on the banded branch (bench.py's grid, 10240 actor slots)
FARM_GOLDENS, FARM_WORLDS, FARM_FRAMES = ("hinge_pendulum", "capsule_stack"), 4096, 100
BANDED_BOXES, BANDED_CAPACITY, BANDED_STEPS = 10_000, 10_240, 40   # 60 before phase 13, 120, 300
# the sweep window (sap_neighbors) of the banded block: over 300 steps of the 10k block the
# card's window certificate summed 1,602,273 at the module's default 16, 4,318 at 32 and 0 at
# 40 and 48 (tools/banded_window.py; at 1,000 boxes the JAX package on the CPU summed 8,206 at
# 16, 72 at 24 and 0 at 32): the narrowest window measured to hold every contact
BANDED_WINDOW = 40
BANDED_COMPARE_BOXES, BANDED_COMPARE_CAPACITY, BANDED_COMPARE_AT = 1000, 1024, 90
SANE_SPEED = 50.0        # m/s and rad/s: K2 is held to plain on farm worlds below it
# phase 10, the simulation tier: the sap pile's worlds and steps; the stand-alone steps on
# the elongated pile and on the 10k boxes; the banded farm's widths and steps; the layered
# crowd
SAP_WORLDS, SAP_STEPS = 16, 120
PILE_BOXES, BANDED10K_BOXES, BANDED10K_STEPS = 4096, 10_000, 40   # 60 before phase 13, 120
PILE_COMPARE_BOXES, PILE_COMPARE_AT = 512, 40   # the stand-alone steps' card-vs-CPU pile
FARM_WIDTHS, BANDED_FARM_STEPS = (1, 64), 60
LAYERED_CHARACTERS, LAYERED_WORLDS, LAYERED_FRAMES = 128, 1024, 30
# the game-content farms (models/physics_scenes.py) and the banded props level
GAME_WORLDS = {"props": 4096, "drive": 4096, "terrain": 1024}
# the banded props level: its hulls, and how many may end unsettled (physics_scenes.
# check_banded_props). The JAX pile test's bounds hold for its 5 hulls; on a pile of hundreds
# both packages leave a few hulls outside them at random: on the level scaled to 256 hulls
# (tools/banded_props_layouts.py on the CPU, seeds 7-12) the JAX package left 0-3 and the port
# 0-6, so the level allows the JAX package's worst share, 3 of 256
BANDED_PROPS_HULLS = 1024
BANDED_PROPS_UNSETTLED = 3 * BANDED_PROPS_HULLS // 256
# the card-vs-CPU compare: hulls (4 of the level's stacks, all on the slab), actor slots, steps
# before its 3 steps, when the stacks are falling onto each other
BANDED_PROPS_COMPARE = (20, 300, 60)
LAYER_REPS = 10          # 20 before phase 13
# The whole script runs three host-bound paths at a cut depth, to make room for phases 14 and
# 15: the elongated piles' settle and the banded farm (phase 10), and the banded props level
# (phase 7); the second cut (the props level 60 -> 30 steps, the settle and the farm 40 -> 20)
# offsets phase 15's ~30 s.
# At the cut depth it reads every certificate, the blow-up and fall gates and the readings; the
# settle gates need the full counts, which the tools that run the paths alone set (FULL_DEPTH:
# tools/sim_tier.py, its "props" run the banded props level)
FULL_DEPTH = False
PILE_SETTLE_STEPS_CUT = 20       # of physics_scenes.PILE_SETTLE_STEPS, 300
BANDED_PROPS_STEPS_CUT = 30      # of physics_scenes.BANDED_PROPS_STEPS, 360
BANDED_FARM_STEPS_CUT = 20       # of BANDED_FARM_STEPS
# the headless demo tick (bench.py --config demo at headless_demo_world's default, ~2k entities;
# bench.py's CLI default would build 10,240) at bench.py's default world count
DEMO_ENTITIES, DEMO_WORLDS = 2048, 4096
LIGHT_DIR = (0.3, -1.0, 0.2)   # bench.py --config render's shadow light
# the card-vs-CPU golden gap, over the first GAP_STEPS steps of each arc (the full arcs before
# the simulation tier joined the script, 300 steps before phase 11; the gaps pass GAP_LIMIT by
# step 132)
GAP_GOLDENS, GAP_LIMIT, GAP_STEPS = ("ballistic", "d6_slider"), 1e-5, 150
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
DT = 1.0 / 60.0
ITERATIONS, POSITION_ITERATIONS = 10, 3
TRANSFORM_ATOL = 1e-5    # entities the physics does not move (root motion included)
BODY_POS_ATOL = 1e-3
BODY_VEL_ATOL = 5e-3
MARGIN = 1e-4            # cull decisions this close to a threshold may flip
CLOCK_ATOL = 1e-6        # animation clocks: adds and fmod, exact on both sides
POSE_ATOL = 1e-5         # poses and palettes: rsqrt and compose chains differ by ulps
PARTICLE_ATOL = 1e-4     # particle channels, |values| <= ~60 (1 ulp at 32..64 is 3.8e-6)
KILL_MARGIN = 1e-4       # kills this close to a threshold (pos.y = 0, t = 6) may flip
STORM_G = 9.8
SCRIPT_MOVERS, SCRIPT_WORLDS = 64, 4096   # bench.py --config scripts (bench.py:306-307,442)
NAV_CROSSING, NAV_WORLDS = 512, 256        # phase 9c: two crossing streams of 512 agents
SCRIPT_ATOL = 1e-5       # fast-path rows card vs CPU: the same float32 formulas, sin/cos ulps
NAV_ATOL = 1e-4          # agents card vs CPU over 3 frames: sqrt/rsqrt ulps at |x| <= 60 m
# phase 11, render and present: the app's main path (app.main's world and frames), the
# presents' sizes, the timing (warm calls, timed calls) and the card-vs-CPU limits
PRESENT_ENTITIES, PRESENT_FRAMES = 2048, 60
PRESENT_SIZES = ((480, 270), (1280, 720))
PRESENT_WARM, PRESENT_REPS, SOFT_REPS = 3, 10, 3
PRESENT_COVERAGE_MIN = 0.999   # share of pixels whose hit mask agrees, card vs CPU
PRESENT_DEPTH_RTOL = 1e-5      # where both hit
PRESENT_RGB_LEVELS, PRESENT_RGB_SHARE = 1, 0.999
SOFT_LEVELS = 2                # the software present's u8 image, card vs CPU
# phase 12, load and save: the stress scene's entities and bodies (models/host_scenes.py), the
# ticks after the load, the tick a checkpoint is taken at, and the ticks after the reload
HOST_ENTITIES, HOST_BODIES, HOST_TICKS, HOST_CKPT_AT, HOST_RELOAD_TICKS = 2048, 64, 60, 30, 10
# phase 13, real assets: the stress scene on the written FBX assets (models/asset_scenes.py), its
# ticks, the on-device present's size, the frames of the game view and the editors' previews,
# the TUI's frames. The game view's restore is held bit for bit outside what a world blob does
# not carry, in either package: the Lua scripts' rows, and the free slots of the model-instance
# store (a blob carries the live instances; a free slot comes back at the store's default)
ASSET_ENTITIES, ASSET_BODIES, ASSET_TICKS = 2048, 64, 60
ASSET_PRESENT, ASSET_EDITOR_FRAMES, TUI_FRAMES = (480, 270), 30, 5
# phase 14, the editor: the stress scene's entities and bodies, the scene view's render_text
# size (a 160x90 image, SceneView's own), its playing frames before and after the layer edit,
# the Runner ticks after the script (the bodies land, for K2's operands), the dry run's shards
EDITOR_ENTITIES, EDITOR_BODIES = 2048, 64
EDITOR_SCENE_TEXT, EDITOR_PLAY_FRAMES, EDITOR_LAND_FRAMES = (160, 47), 2, 60
EDITOR_DRYRUN_SHARDS = 2
# phase 15, the JAX package's last surface: the flagship's frames under each solver_backend
# (from its bodies piled, so that contacts are active from the first frame) and the largest
# body-state gap of "jnp" against "auto" after the first frame: K2's own limit against its
# plain version, which the jnp solve equals on the CPU to ~1e-8 (the two part later: the jnp
# projection caps a frame's push at 5 cm, K2's does not); the classic slot tiers' steps from
# the 10k-box drop's step-1200 state (tests/data/boxes_step1200.npz); the skinned animators;
# the skinned points against the host's 4-bone formula (metres)
SURFACE_FRAMES = 30
SURFACE_BACKENDS = ("auto", "pallas", "jnp")
SURFACE_JNP_ATOL = 1e-4
# propagate and propagate_indexed compose as propagate_plan does (bit for bit on the CPU);
# pointer jumping groups the same composes otherwise: ulps of positions up to ~100 m
SURFACE_DOUBLING_ATOL = 1e-3
SURFACE_BOX_STEPS = 30
SURFACE_SLOT_TIERS = {"n_sweeps=1": dict(n_sweeps=1), "warm_start=False": dict(warm_start=False),
                      "mass_split=False": dict(mass_split=False),
                      "sleeping=False": dict(sleeping=False),
                      "all four": dict(n_sweeps=1, warm_start=False, mass_split=False,
                                       sleeping=False)}
SURFACE_ANIMATORS = 16
SURFACE_SKIN_ATOL = 1e-4
# phase 16, the JAX classes' last members: the demo's worlds, the worlds run again on the CPU,
# the frames after each edit, and the palette timing's frames a run (after its warm frames),
# four runs in the order on, off, off, on
MEMBERS_DEMO_WORLDS, MEMBERS_CPU_WORLDS, MEMBERS_EDIT_FRAMES = 1024, 2, 3
MEMBERS_PALETTE_WARM, MEMBERS_PALETTE_FRAMES = 3, 12
BLOB_UNCARRIED = ("modules.script.",)
INSTANCE_ROWS = ("modules.renderer.mi_", "modules.renderer.culling.", "modules.renderer.prev_")
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM (NVIDIA's data sheet), at its 700 W limit
FP32_FLOP_PER_S = 67e12     # outside the tensor cores
INT_ALU_OP_PER_S = 132 * 64 * 1.98e9  # integer ALU pipe: 64 a clock on each of 132 SMs at 1.98 GHz
TF_WORLDS = 4096            # the Threefry kernel's timed shape: the flagship cell's worlds
KERNEL_REPS = 50
BJ_WORLDS, BJ_LAND_FRAMES, BJ_REPS = 4, 60, 20   # the box-drop cell's W; the lattice has landed
BJ_PLAIN_ATOL = 1e-4        # the kernel sums a body's impulses in another order than plain
BG_PLAIN_ATOL = 1e-5        # BG's narrowphase keeps plain's order of operations
BG_DEPTH_TIE = 1e-5         # a BG flag may differ from plain's only this close to depth 0
NO_LIBRARY = "no single PyTorch call computes it"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call of fn() over `reps` calls, with CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate(plain, kernel, plain_reps: int, kernel_reps: int = KERNEL_REPS):
    """Times in the order plain, kernel, kernel, plain; returns the means."""
    p1 = cuda_time(plain, plain_reps)
    k1, k2 = cuda_time(kernel, kernel_reps), cuda_time(kernel, kernel_reps)
    p2 = cuda_time(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: int, flops: int, op_rate: float = FP32_FLOP_PER_S):
    """(least ms for the work on the card, "bytes" or "operations"): the
    bytes over HBM_BYTES_PER_S or the operations over `op_rate`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / op_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(xs, ys) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def random_planes(num_worlds: int, dev, seed: int = 2):
    """A random perspective view per world: planes [W, 8, 4]."""
    import torch

    from lumixengine_tpu_torch.core import geometry as geom

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((num_worlds, 4), generator=g, device=dev)
    eye = torch.randn((num_worlds, 3), generator=g, device=dev) * 20.0
    return geom.perspective_frustum(eye, q / q.norm(dim=-1, keepdim=True),
                                    1.2, 16 / 9, 0.3, 150.0).planes.contiguous()


def k1_check(centers, radii, plane_sets):
    """K1 against its plain version over the same spheres, for each plane
    set [W, 8, 4]: (mismatches, max abs err, visible fraction of each set)."""
    import torch

    from lumixengine_tpu_torch.ops import culling as cull

    bad, err, fracs = 0, 0.0, []
    for planes in plane_sets:
        vk = cull.frustum_cull_cuda(centers, radii, planes)
        vp = cull.frustum_cull_plain(centers, radii, planes)
        torch.cuda.synchronize()
        bad += int((vk != vp).sum())
        err = max(err, max_err([vk.float()], [vp.float()]))
        fracs.append(float(vk.float().mean()))
    return bad, err, fracs


def k1_on_path(name, world, state, phase="5"):
    """K1 against its plain version on the operands the path's cull pass
    gives it at the path's own W and K: the world camera and a random view
    per world. Raises on a mismatch."""
    from lumixengine_tpu_torch.renderer import pipeline

    rm = world.modules["renderer"]
    frustum, centers, radii = pipeline.cull_operands(state, state.modules["renderer"], rm.statics())
    centers, radii = centers.contiguous(), radii.contiguous()
    w = centers.shape[0]
    bad, err, fracs = k1_check(centers, radii, (frustum.planes.contiguous(),
                                                random_planes(w, centers.device)))
    shape = list(centers.shape)
    log(f"[{phase} {name}] K1 on the path's own operands {shape}, world camera and random views: "
        f"{bad} mismatches with the plain version (visible fractions "
        f"{[float(f'{f:.4f}') for f in fracs]})")
    if bad:
        raise AssertionError(f"K1 is not bit-exact on the {name} path: {bad} mismatches")
    return {"mismatches": bad, "max_abs_err": err, "shape": shape}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models.demo_scenes import (full_frame_world,
                                                          particle_stress_world, pile_bodies,
                                                          skinned_crowd_world)
    from lumixengine_tpu_torch.core import random as prng
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import hierarchy as hier
    from lumixengine_tpu_torch.ops import native
    from lumixengine_tpu_torch.ops import solver as S
    from lumixengine_tpu_torch.parallel.mesh import replicate_state
    from lumixengine_tpu_torch.renderer import pipeline

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    def mark(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s of the host's clock")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    W = WORLDS

    # 1. the card
    log(f"[1 device] {card} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    native.library()
    log(f"[2 build] {native.library_path().name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(native.NVCC_FLAGS[:2])})")
    report = ptxas_report(native.build_log())
    for line in report:
        log(f"[2 ptxas] {line}")
    spills = [line for line in report if line.startswith(("TF", "BG")) and "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    if spills or not all(any(line.startswith(name) for line in report)
                         for name in ("TF draw uniform", "BG grids")):
        raise AssertionError(f"the Threefry or banded grids kernels spill, or ptxas reports none "
                             f"of them: {spills}")

    engine, world, _renderer, _anim, _phys = full_frame_world(N_ENTITIES, 0, N_BODIES, 0)
    rm, pm = world.modules["renderer"], world.modules["physics"]
    single = world.device_state(dev)
    step = engine.build_step(world, dev, extra=rm.cull_pass)

    # 3. K1 on the cull pass's operands: the world camera, and random views
    batch = replicate_state(single, W, torch.Generator(device=dev).manual_seed(1))
    batch = batch.replace(world=hier.propagate_plan(batch.local, world.plan))
    frustum, centers, radii = pipeline.cull_operands(batch, batch.modules["renderer"], rm.statics())
    centers, radii = centers.contiguous(), radii.contiguous()
    cam_planes = frustum.planes.contiguous()
    del batch
    k1_bad, k1_err, fracs = k1_check(centers, radii, (cam_planes, random_planes(W, dev)))
    log(f"[3 K1] [{W},3,{centers.shape[-1]}] world-camera and random views: "
        f"{k1_bad} mismatches with the plain version")
    if k1_bad:
        raise AssertionError(f"K1 is not bit-exact: {k1_bad} mismatches")
    if not all(0.0 < f < 1.0 for f in fracs):
        raise AssertionError(f"K1 check is degenerate: visible fractions {fracs}")

    # 4. K2 on the main path's shapes: settled contact sets, and the same worlds piled up
    settle = replicate_state(single, W, torch.Generator(device=dev).manual_seed(3))
    for _ in range(SETTLE_FRAMES):
        settle = step(settle, DT)
    piled = pile_bodies(settle)
    k2_err = 0.0
    problems = {}
    faults = {"one iteration short": 0.0, "one projection pass short": 0.0}
    wide = wide_problem(dev, W, replicate_state)
    k2_shapes = {}
    for name, s in (("settled", settle), ("piled", piled), ("piled NB=256", wide)):
        prob = pm.solver_problem(s, DT) if name != "piled NB=256" else s
        problems[name] = prob
        k2_shapes[f"phase 4 {name}"] = [prob.vel.shape[0], prob.vel.shape[-1], prob.act.shape[-1]]
        n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
        outk = S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)
        outp = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
        err = max_err(outk, outp)
        ok = all(bool(torch.isfinite(a).all()) for a in outk)
        log(f"[4 K2] {name}: W={prob.vel.shape[0]} NB={prob.vel.shape[-1]} C={prob.act.shape[-1]}"
            f" active {int(prob.act.sum())} (pair stream {n_pair}), max abs err vs plain "
            f"{err:.3e} (limit {S.K2_PLAIN_ATOL:g})")
        if not ok or not err <= S.K2_PLAIN_ATOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err} (finite {ok})")
        if int(prob.act.sum()) == 0 or (name.startswith("piled") and n_pair == 0):
            raise AssertionError(f"K2 check on {name} has no contacts to solve")
        k2_err = max(k2_err, err)
        if name == "piled NB=256":
            continue
        for fault, its in (("one iteration short", (ITERATIONS - 1, POSITION_ITERATIONS)),
                           ("one projection pass short", (ITERATIONS, POSITION_ITERATIONS - 1))):
            faults[fault] = max(faults[fault], max_err(S.solve_plain(prob, *its), outp))
    shown = {k: float(f"{v:.3e}") for k, v in faults.items()}
    log(f"[4 K2] plain version with a planted fault, max abs err vs plain: {shown}")
    if not min(faults.values()) > S.K2_PLAIN_ATOL:
        raise AssertionError(f"the K2 limit {S.K2_PLAIN_ATOL} does not catch a planted fault: {faults}")
    del settle, piled, wide, problems["piled NB=256"]
    mark("phases 1-4")

    # 5. the main paths
    stream = check_threefry(dev, W)
    log(f"[5 rng] threefry on the card vs the CPU, first 8 words of one draw: {stream}")
    flag = full_frame_world(N_ENTITIES, N_CHARACTERS, N_BODIES, N_PARTICLES)
    runs = {"flagship": run_path("flagship", flag, W, dev, replicate_state, map_tensors),
            "slice": run_path("slice", (engine, world), SLICE_WORLDS, dev, replicate_state,
                              map_tensors, step=step),
            "crowd": run_path("crowd", skinned_crowd_world(CROWD_CHARACTERS), CROWD_WORLDS, dev,
                              replicate_state, map_tensors),
            "particles": run_path("particles", particle_stress_world(STORM_CAPACITY), 1, dev,
                                  replicate_state, map_tensors)}
    runs["particles"].update(units=STORM_CAPACITY, unit="particle")  # bench.py's unit here
    from lumixengine_tpu_torch.models.demo_scenes import headless_demo_world

    runs["demo"] = run_path("demo", headless_demo_world(DEMO_ENTITIES), DEMO_WORLDS, dev,
                            replicate_state, map_tensors, views=True)
    runs["render"] = run_path("render", flag, W, dev, replicate_state, map_tensors, views=True,
                              passes=True)
    attach = run_attachments(dev, replicate_state)
    mark("phase 5")

    # 6. the 10k-box drop
    boxes = run_boxes(dev)
    drop = box_drop_operands(dev)
    bj = check_banded_jacobi(card, drop)
    bg = check_banded_grids(card, drop)
    del drop
    mark("phase 6")

    # 7. the PhysicsModule: the goldens, the farm, the banded branch
    goldens = run_goldens(dev)
    gaps = {name: golden_gap(name, dev) for name in GAP_GOLDENS}
    mark("phase 7 goldens and gaps")
    farms = {name: run_farm(name, dev, replicate_state) for name in FARM_GOLDENS}
    banded = run_banded(dev)
    mark("phase 7 farms and the banded block")
    game = {kind: run_game(kind, dev, card) for kind in GAME_WORLDS}
    mark("phase 7 game farms")
    banded_props = run_banded_props(dev, card)
    mark("phase 7 banded props")

    # 9. the full engine: the scripts config, the game world, navigation at width
    scripts = run_scripts_config(dev, replicate_state, map_tensors)
    game_world = run_game_world(dev)
    nav_width = run_nav_width(dev, replicate_state, map_tensors)
    mark("phase 9")

    # 10. the simulation tier: sap, the stand-alone steps, the batched banded farm, the
    # layered crowd
    sim = run_sim_tier(dev, card, replicate_state, map_tensors)
    mark("phase 10")

    # 11. render and present: the app's main path, both presents, card vs CPU
    present = run_present(dev, card)
    mark("phase 11")

    # 12. load and save: a .unv written, loaded, ticked, saved, reloaded, checkpointed
    host = run_host_tier(dev, card)
    mark("phase 12")

    # 13. real assets: the codecs, the asset compiler, the editor's views, the terminal
    assets = run_asset_tier(dev, card)
    mark("phase 13")

    # 14. the editor: EditorApp's key script and views on the card, card vs CPU, the dry run
    editor = run_editor_tier(dev, card)
    mark("phase 14")

    # 15. the JAX package's last surface: solver_backend, the classic slot tier, the other
    # propagations, culling_system.cull, skinning, the floating-point traps
    surface = run_surface_tier(dev, card)
    mark("phase 15")

    # 16. the JAX classes' last members: property edits through the registry on the demo and
    # the flagship, set_model, set_animator_input, the palette's cost
    members = run_members_tier(dev, card)
    mark("phase 16")

    # 8. timings
    k1_ms, k1_plain = alternate(lambda: cull.frustum_cull_plain(centers, radii, cam_planes),
                                lambda: cull.frustum_cull_cuda(centers, radii, cam_planes), 20)
    k1_bound, k1_by = bound(cull.k1_bytes(W, N_ENTITIES), cull.k1_flops(W, N_ENTITIES))
    k2 = {}
    for name in ("settled", "piled"):
        prob = problems[name]
        w_, _, nb = prob.vel.shape
        c = prob.act.shape[-1]
        n_active = int(prob.act.sum())
        n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
        ms, plain_ms = alternate(lambda: S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS),
                                 lambda: S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS), 5)
        nbytes = S.k2_bytes(w_, nb, c, int((prob.act != 0).sum()))
        bound_ms, by = bound(nbytes, S.k2_flops(w_, nb, c, n_active, n_pair, ITERATIONS,
                                                POSITION_ITERATIONS))
        k2[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": by, "share_of_bound": bound_ms / ms, "W": w_, "C": c}
        log(f"[8 K2] {card}: {name} W={w_} NB={nb} C={c} (active {n_active}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {nbytes} bytes, bound {bound_ms:.4f} ms ({by}), share of bound "
            f"{bound_ms / ms:.3f}")
    tf_key = prng.fold_in(prng.PRNGKey(0, dev), torch.arange(TF_WORLDS, device=dev))
    tf_ms, tf_plain_ms = alternate(
        lambda: prng.uniform_plain(prng.fold_in_plain(tf_key, 5), (N_PARTICLES,)),
        lambda: prng.fold_uniform(tf_key, 5, (N_PARTICLES,)), 3)
    tf_ops, tf_bytes = (prng.threefry_alu_ops(TF_WORLDS, N_PARTICLES),
                        prng.threefry_bytes(TF_WORLDS, N_PARTICLES))
    tf_bound, tf_by = bound(tf_bytes, tf_ops, INT_ALU_OP_PER_S)
    log(f"[8 TF] {card}: fold_uniform [{TF_WORLDS}, {N_PARTICLES}] {tf_ms:.4f} ms, plain "
        f"{tf_plain_ms:.4f} ms, {tf_ops} ALU-pipe ops and {tf_bytes} bytes, bound {tf_bound:.4f} ms "
        f"({tf_by}), share of bound {tf_bound / tf_ms:.3f}")
    prob = problems["settled"]
    paths = "; ".join(
        f"{name} {r['ms']:.3f} ms/frame at W={r['worlds']} = "
        f"{r['worlds'] * r['units'] / (r['ms'] / 1e3):.4g} {r['unit']}-steps/s ({r['ops']} ops/frame)"
        for name, r in runs.items())
    log(f"[8 time] {card}: {paths}; boxes {boxes['ms']:.3f} ms/step at {N_BOXES} bodies = "
        f"{N_BOXES / (boxes['ms'] / 1e3):.4g} body-steps/s ({boxes['ops']} ops/step);"
        f" K1 [{W},3,{N_ENTITIES}] {k1_ms:.4f} ms (plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms);"
        f" K2 settled W={prob.vel.shape[0]} C={prob.act.shape[-1]} {k2['settled']['ms']:.4f} ms "
        f"(plain {k2['settled']['plain_ms']:.4f} ms, bound {k2['settled']['bound_ms']:.4f} ms)")

    log(f"[8 time] {card}: " + "; ".join(
        f"farm {name} {r['ms']:.3f} ms/frame at W={FARM_WORLDS} = {r['rate']:.4g} body-steps/s "
        f"({r['ops']} ops/frame)" for name, r in farms.items())
        + f"; banded {BANDED_BOXES} boxes {banded['ms']:.3f} ms/step = "
        f"{BANDED_BOXES / (banded['ms'] / 1e3):.4g} body-steps/s ({banded['ops']} ops/step)")
    for name in ("render", "demo"):
        cl = runs[name]["clusters"]
        log(f"[8 clusters] {card}: fill_clusters on the {name} path at W={cl['W']}, C={cl['C']}, "
            f"{cl['L_live']} lights in {cl['L']} slots (padded to {cl['L_pad']}): {cl['ms']:.4f} ms "
            f"a call on the card's clock (enqueue {cl['enqueue_ms']:.4f} ms), {cl['ops']} torch "
            f"ops; bound {cl['bound_ms']:.4f} ms ({cl['bound_by']}: {cl['bytes']} bytes, "
            f"{cl['flops']} float ops over the live lights), share of bound "
            f"{cl['bound_ms'] / cl['ms']:.6f}; over every padded light slot, as the pass computes "
            f"them: {cl['flops_padded']} float ops, {cl['bound_ms_padded']:.4f} ms, share "
            f"{cl['bound_ms_padded'] / cl['ms']:.6f}")
    k1_paths = {name: r["k1"] for name, r in runs.items()}
    k1_paths["attachments"] = attach["k1"]
    k1_paths["scripts"] = scripts["k1"]
    k1_paths["layered"] = sim["layered"]["k1"]
    k1_paths["present"] = present["k1"]
    k1_paths["host_tier"] = host["k1"]
    k1_paths["asset_tier"] = assets["k1"]
    k1_paths["editor_tier"] = editor["k1"]
    k1_paths["surface_tier"] = surface["k1"]
    k1_paths.update({f"members_tier {k}": r for k, r in members["k1"].items()})
    k1_bad += sum(r["mismatches"] for r in k1_paths.values())
    k1_err = max(k1_err, *(r["max_abs_err"] for r in k1_paths.values()))
    log(f"[8 goldens] card vs CPU over the first {GAP_STEPS} steps of the arcs: {gaps}")
    log(f"[8 time] {card}: " + "; ".join(
        f"{kind} {r['ms']:.3f} ms/frame at W={r['worlds']} = {r['rate']:.4g} body-steps/s "
        f"({r['ops']} ops/frame), K2 {r['k2']['ms']:.4f} ms (plain {r['k2']['plain_ms']:.4f}, "
        f"bound {r['k2']['bound_ms']:.4f})" for kind, r in game.items())
        + f"; banded props {BANDED_PROPS_HULLS} hulls {banded_props['ms']:.3f} ms/step = "
        f"{BANDED_PROPS_HULLS / (banded_props['ms'] / 1e3):.4g} body-steps/s "
        f"({banded_props['ops']} ops/step)")
    log(f"[8 time] {card}: scripts config {scripts['ms']:.3f} ms/frame at W={SCRIPT_WORLDS} = "
        f"{scripts['rate']:.4g} entity-steps/s ({scripts['ops']} ops/frame); game world "
        f"{game_world['ms_tick']:.3f} ms a Runner tick at W=1 (host clock); navigation width "
        f"{nav_width['ms']:.3f} ms/frame at W={NAV_WORLDS} = {nav_width['rate']:.4g} agent-steps/s "
        f"({nav_width['ops']} ops/frame)")
    k2_shapes.update({f"farm {name}": [r["k2"]["W"], r["k2"]["NB"], r["k2"]["C"]]
                      for name, r in farms.items()})
    k2_shapes.update({kind: [r["k2"]["W"], r["k2"]["NB"], r["k2"]["C"]] for kind, r in game.items()})
    k2_shapes["scripts (empty)"] = [scripts["k2"][k] for k in ("W", "NB", "C")]
    k2_shapes["host tier"] = [host["k2"][k] for k in ("W", "NB", "C")]
    k2_shapes["asset tier"] = [assets["k2"][k] for k in ("W", "NB", "C")]
    k2_shapes["editor tier"] = [editor["k2"][k] for k in ("W", "NB", "C")]
    k2_shapes["surface tier"] = [surface["k2"][k] for k in ("W", "NB", "C")]
    k2_shapes["members tier"] = [members["k2"][k] for k in ("W", "NB", "C")]
    piles = sim["piles"]
    log(f"[8 time] {card}: sap pile {sim['sap']['ms']:.3f} ms/step at W={SAP_WORLDS} = "
        f"{sim['sap']['rate']:.4g} body-steps/s ({sim['sap']['ops']} ops/step); "
        + "; ".join(f"{name} {r['ms']:.3f} ms/step = {r['rate']:.4g} body-steps/s ({r['ops']} "
                    f"ops/step)" for name, r in (("big-world step, 4096 boxes", piles["dynamic"]),
                                                 ("banded step, 4096 boxes", piles["banded"]),
                                                 ("banded step, 10k boxes", piles["banded_10k"])))
        + "; " + "; ".join(f"banded farm W={w} {r['ms']:.3f} ms/step = {r['rate']:.4g} "
                           f"body-steps/s ({r['ops']} ops/step)" for w, r in sim["farm"].items())
        + f"; layered crowd {sim['layered']['ms']:.3f} ms/frame at W={LAYERED_WORLDS} = "
        f"{sim['layered']['rate']:.4g} entity-steps/s ({sim['layered']['ops']} ops/frame)")
    sim_launches = {"sap": sim["sap"]["launches"], "layered": sim["layered"]["launches"],
                    **{f"pile {k}": r["launches"] for k, r in piles.items()},
                    **{f"farm W={w}": r["launches"] for w, r in sim["farm"].items()}}
    main_launches = runs["flagship"]["launches"]
    kernels = [
        {"name": "K1 frustum_cull", "route": "cuda", "source": "lumixengine_tpu_torch/csrc/cull.cu",
         "replaces": "lumixengine_tpu/ops/culling.py:54", "launches": main_launches["K1"],
         "launches_slice": runs["slice"]["launches"]["K1"],
         "launches_crowd": runs["crowd"]["launches"]["K1"],
         "launches_particles": runs["particles"]["launches"]["K1"],
         "launches_demo": runs["demo"]["launches"]["K1"],
         "launches_render": runs["render"]["launches"]["K1"],
         "launches_prepare_view": runs["render"]["view_launches"] + runs["demo"]["view_launches"],
         "launches_attachments": attach["launches"]["K1"],
         "launches_scripts": scripts["launches"]["K1"],
         "launches_game_world": game_world["launches"]["K1"],
         "launches_nav_width": nav_width["launches"]["K1"],
         "launches_layered": sim["layered"]["launches"]["K1"],
         "launches_present": present["launches"]["K1"],
         "launches_present_views": present["view_launches"]["K1"],
         "launches_host_tier": host["launches"]["K1"],
         "launches_asset_tier": assets["launches"]["K1"],
         "launches_editor_tier": editor["launches"]["K1"],
         "launches_dryrun": editor["dryrun"]["launches"]["K1"],
         "launches_surface_tier": surface["launches"]["K1"],
         "launches_members_tier": members["launches"]["K1"],
         "launches_sim_tier_physics": {k: v["K1"] for k, v in sim_launches.items()
                                       if k != "layered"},
         "launches_physics": goldens["launches"]["K1"] + banded["launches"]["K1"]
         + banded_props["launches"]["K1"] + sum(r["launches"]["K1"] for r in (*farms.values(),
                                                                              *game.values())),
         "max_abs_err": k1_err, "mismatches": k1_bad,
         "checked_shapes": {"phase 3": [W, 3, N_ENTITIES], **{
             name: r["shape"] for name, r in k1_paths.items()}},
         "ms": k1_ms, "plain_ms": k1_plain,
         "bytes": cull.k1_bytes(W, N_ENTITIES), "bound_ms": k1_bound, "bound_by": k1_by,
         "bound_of": k1_by, "share_of_bound": k1_bound / k1_ms, "library_ms": None,
         "library_note": NO_LIBRARY},
        {"name": "K2 solve_contacts_fused", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/solver.cu",
         "replaces": "lumixengine_tpu/ops/solver_pallas.py:165", "launches": main_launches["K2"],
         "launches_slice": runs["slice"]["launches"]["K2"],
         "launches_render": runs["render"]["launches"]["K2"],
         "launches_scripts": scripts["launches"]["K2"],
         "launches_game_world": game_world["launches"]["K2"],
         "launches_nav_width": nav_width["launches"]["K2"],
         "launches_sim_tier": {k: v["K2"] for k, v in sim_launches.items()},
         "launches_present": present["launches"]["K2"],
         "launches_host_tier": host["launches"]["K2"],
         "host_tier": host["k2"],
         "launches_asset_tier": assets["launches"]["K2"],
         "asset_tier": assets["k2"],
         "launches_editor_tier": editor["launches"]["K2"],
         "launches_dryrun": editor["dryrun"]["launches"]["K2"],
         "editor_tier": editor["k2"],
         "launches_surface_tier": surface["launches"]["K2"],
         "launches_surface_backends": surface["k2_backends"],
         "surface_tier": surface["k2"],
         "launches_members_tier": members["launches"]["K2"],
         "members_tier": members["k2"],
         "launches_goldens": goldens["launches"]["K2"],
         "launches_farm": {name: r["launches"]["K2"] for name, r in farms.items()},
         "launches_banded": banded["launches"]["K2"],
         "launches_game": {**{kind: r["launches"]["K2"] for kind, r in game.items()},
                           "banded_props": banded_props["launches"]["K2"]},
         "max_abs_err": max(k2_err, goldens["k2_err"], scripts["k2"]["max_abs_err"],
                            host["k2"]["max_abs_err"], assets["k2"]["max_abs_err"],
                            editor["k2"]["max_abs_err"], surface["k2"]["max_abs_err"],
                            members["k2"]["max_abs_err"],
                            *(r["k2"]["max_abs_err"] for r in (*farms.values(),
                                                               *game.values()))),
         "checked_shapes": {"[W, NB, C]": k2_shapes},
         "ms": k2["settled"]["ms"], "plain_ms": k2["settled"]["plain_ms"],
         "bytes": k2["settled"]["bytes"], "bound_ms": k2["settled"]["bound_ms"],
         "bound_by": k2["settled"]["bound_by"], "bound_of": k2["settled"]["bound_by"],
         "share_of_bound": k2["settled"]["share_of_bound"], "ms_piled": k2["piled"]["ms"],
         "plain_ms_piled": k2["piled"]["plain_ms"], "bound_ms_piled": k2["piled"]["bound_ms"],
         "share_of_bound_piled": k2["piled"]["share_of_bound"],
         "farm": {name: r["k2"] for name, r in farms.items()},
         "game": {kind: r["k2"] for kind, r in game.items()}, "library_ms": None,
         "library_note": NO_LIBRARY},
        {"name": "TF threefry", "route": "cuda", "source": "lumixengine_tpu_torch/csrc/threefry.cu",
         "replaces": None, "replaces_note": "no TPU kernel: the JAX package draws through "
         "jax.random, whose Threefry XLA compiles itself", "launches": main_launches["TF"],
         "launches_paths": {
             **{name: r["launches"]["TF"] for name, r in runs.items()},
             "attachments": attach["launches"]["TF"], "scripts": scripts["launches"]["TF"],
             "game_world": game_world["launches"]["TF"], "nav_width": nav_width["launches"]["TF"],
             "layered": sim["layered"]["launches"]["TF"], "present": present["launches"]["TF"],
             "present_views": present["view_launches"]["TF"], "host_tier": host["launches"]["TF"],
             "asset_tier": assets["launches"]["TF"], "editor_tier": editor["launches"]["TF"],
             "dryrun": editor["dryrun"]["launches"]["TF"], "surface_tier": surface["launches"]["TF"],
             "members_tier": members["launches"]["TF"]},
         "checked": stream, "shape": [TF_WORLDS, N_PARTICLES], "ms": tf_ms, "plain_ms": tf_plain_ms,
         "bytes": tf_bytes, "alu_ops": tf_ops, "bound_ms": tf_bound, "bound_by": tf_by,
         "bound_of": tf_by, "share_of_bound": tf_bound / tf_ms, "library_ms": None,
         "library_note": NO_LIBRARY},
        {"name": "BJ banded_jacobi", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/banded_jacobi.cu", "replaces": None,
         "replaces_note": "no TPU kernel: the JAX package's banded solve is jnp, which XLA fuses",
         "launches": bj["launches_frame"], "launches_banded_block": banded["launches"].get("BJ"),
         **{key: bj[key] for key in ("max_abs_err", "bit_identical", "shape", "n_active", "ms",
                                     "plain_ms", "bytes", "bound_ms", "bound_by",
                                     "share_of_bound")},
         "bound_of": bj["bound_by"], "library_ms": None, "library_note": NO_LIBRARY},
        {"name": "BG banded_grids", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/banded_grids.cu", "replaces": None,
         "replaces_note": "no TPU kernel: the JAX package's banded contact stage is jnp, which "
         "XLA fuses", "launches": bg["launches_frame"],
         "launches_banded_block": banded["launches"].get("BG"),
         "launches_banded_props": banded_props["launches"].get("BG"),
         "launches_sim_tier": {k: v.get("BG") for k, v in sim_launches.items()},
         **{key: bg[key] for key in ("max_abs_err", "flags_at_ties", "bit_identical", "shape",
                                     "n_active", "ms", "plain_ms", "bytes", "bound_ms",
                                     "bound_by", "share_of_bound")},
         "bound_of": bg["bound_by"], "library_ms": None, "library_note": NO_LIBRARY},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def event_times(fn, warm: int, reps: int):
    """`warm` calls of fn(), then `reps` calls each between two CUDA events:
    (median ms, spread max - min ms)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], times[-1] - times[0]


def present_gap(got, ref):
    """Card against CPU for one on-device present, each (rgb, depth,
    overflow) on the host: the figures and whether they hold."""
    import numpy as np

    rgb, depth, ov = (np.asarray(x) for x in got)
    rrgb, rdepth, rov = (np.asarray(x) for x in ref)
    hit, rhit = np.isfinite(depth), np.isfinite(rdepth)
    both = hit & rhit
    diff = np.abs(rgb.astype(np.int32) - rrgb.astype(np.int32)).max(axis=-1)
    fig = {"overflow": [int(ov), int(rov)], "coverage": float((hit == rhit).mean()),
           "depth_rel": float((np.abs(depth[both] - rdepth[both]) / rdepth[both]).max())
           if both.any() else 0.0,
           "rgb_share": float((diff <= PRESENT_RGB_LEVELS).mean()), "rgb_max": int(diff.max())}
    ok = (int(ov) == int(rov) and fig["coverage"] >= PRESENT_COVERAGE_MIN
          and fig["depth_rel"] <= PRESENT_DEPTH_RTOL and fig["rgb_share"] >= PRESENT_RGB_SHARE)
    return fig, ok


def run_present(dev, card):
    """Phase 11: app.main's path on the card — headless_demo_world(2048)
    through the Runner (start, PRESENT_FRAMES ticks with the cull pass),
    then present() with the builtin plugins and present_tpu() at each of
    PRESENT_SIZES — timed, counted, the on-device present once with every
    synchronizing call an error and twice for identical bytes, K1 bit for
    bit on the path's operands, and the card against the CPU from one
    state (the CPU running the port's presents)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models.demo_scenes import headless_demo_world
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.renderer import gpu_soft, gpu_tpu, plugins

    engine, world, renderer = headless_demo_world(PRESENT_ENTITIES)
    engine.device = dev
    runner = app.Runner([], engine=engine)
    runner.use_world(world)
    runner.start()
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    runner.run(PRESENT_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    log(f"[11 present] {card}: headless_demo_world({PRESENT_ENTITIES}) through Runner.tick, "
        f"{PRESENT_FRAMES} frames in {wall:.2f} s ({wall / PRESENT_FRAMES * 1e3:.3f} ms a tick "
        f"on the host's clock), launches {launches}, metrics {runner.metrics()}")
    if launches["K1"] != PRESENT_FRAMES:
        raise AssertionError(f"present path: K1 launched {launches['K1']} times in "
                             f"{PRESENT_FRAMES} ticks")
    state = runner.state
    k1 = k1_on_state("11 present", world, state)

    plugins.install_builtins(renderer)
    out = {"k1": k1, "launches": launches, "tick_ms_host": wall / PRESENT_FRAMES * 1e3}
    # the software present: host raster, the plugins' passes on the card
    _zero_launches()
    img = runner.present(width=480, height=270)
    view_launches = _launches()
    if img.shape != (270, 480, 3) or img.dtype != np.uint8 or not img.std() > 4.0:
        raise AssertionError(f"software present: {img.shape} {img.dtype} std {img.std()}")
    soft_ms, soft_spread = event_times(lambda: runner.present(width=480, height=270), 1, SOFT_REPS)
    _, soft_ops = count_ops(lambda: runner.present(width=480, height=270))
    log(f"[11 present] {card}: present() 480x270 with {len(renderer.plugins)} builtin plugins: "
        f"{soft_ms:.3f} ms a present (median of {SOFT_REPS}, spread {soft_spread:.3f} ms; CUDA "
        f"events around the whole call, host raster included), {soft_ops} torch ops a present, "
        f"K1 launches in the first {view_launches['K1']} (prepare_view)")
    out.update(view_launches=view_launches, soft={"ms": soft_ms, "spread": soft_spread,
                                                   "ops": soft_ops})
    # the on-device present
    gpu_out = {}
    for w, h in PRESENT_SIZES:
        tp = gpu_tpu.TpuPresent(w, h)
        rgb, depth, ov = tp(runner)
        rgb2, depth2, ov2 = tp(runner)
        same = bool(torch.equal(rgb, rgb2) and torch.equal(depth, depth2) and int(ov) == int(ov2))
        if not same:
            raise AssertionError(f"present_tpu {w}x{h}: two calls on one state differ")
        torch.cuda.set_sync_debug_mode("error")
        try:
            tp(runner)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms, spread = event_times(lambda: tp(runner), PRESENT_WARM, PRESENT_REPS)
        _, ops = count_ops(lambda: tp(runner))
        _, raster_ops = count_ops(lambda: tp.raster_stage(state))
        r_ms, r_dev = layer_time(lambda: tp.raster_stage(state), 5)
        r = tp.raster_stage(state)
        p_ms, p_dev = layer_time(lambda: tp.passes_stage(state, r[0], r[1]), 5)
        t1 = time.perf_counter()
        host = runner.present_tpu(width=w, height=h)
        host_ms = (time.perf_counter() - t1) * 1e3
        if host[0].shape != (h, w, 3) or not np.isfinite(host[1][np.isfinite(host[1])]).all():
            raise AssertionError(f"present_tpu {w}x{h}: {host[0].shape}")
        fill = float(torch.isfinite(depth).float().mean())
        gpu_out[(w, h)] = (rgb.cpu().numpy(), depth.cpu().numpy(), int(ov))
        out[f"tpu_{w}x{h}"] = {"ms": ms, "spread": spread, "ops": ops, "raster_ops": raster_ops,
                               "overflow": int(ov), "raster_device_ms": r_dev,
                               "passes_device_ms": p_dev, "host_ms": host_ms,
                               "soup_tris": len(tp.soup.tri)}
        log(f"[11 present] {card}: present_tpu {w}x{h}: {ms:.3f} ms a present (CUDA events, "
            f"median of {PRESENT_REPS} after {PRESENT_WARM} warm, spread {spread:.3f} ms), "
            f"{ops} torch ops a present ({raster_ops} in the raster), overflow {int(ov)}, "
            f"{len(tp.soup.tri)} soup triangles, {fill:.4f} of the pixels hit; device time: "
            f"raster {r_dev if r_dev is None else round(r_dev, 4)} ms ({r_ms:.4f} on events), "
            f"decal + light + splat passes {p_dev if p_dev is None else round(p_dev, 4)} ms "
            f"({p_ms:.4f} on events); Runner.present_tpu with the image read back "
            f"{host_ms:.3f} ms on the host's clock; two calls identical, one call with every "
            f"synchronizing CUDA call an error")
    # card against CPU from one state: the port's presents on the CPU
    cpu_runner = app.Runner([], engine=engine)
    cpu_runner.use_world(world)
    cpu_runner.state = map_tensors(lambda x: x.cpu(), state)
    gaps = {}
    for w, h in PRESENT_SIZES:
        fig, ok = present_gap(gpu_out[(w, h)], gpu_tpu.TpuPresent(w, h)(cpu_runner))
        gaps[f"tpu_{w}x{h}"] = fig
        log(f"[11 present] present_tpu {w}x{h} card vs CPU: overflow {fig['overflow']} (equal), "
            f"hit masks agree on {fig['coverage']:.6f} of the pixels (limit "
            f"{PRESENT_COVERAGE_MIN}), depth {fig['depth_rel']:.3e} relative where both hit "
            f"(limit {PRESENT_DEPTH_RTOL:g}), rgb within {PRESENT_RGB_LEVELS} level on "
            f"{fig['rgb_share']:.6f} (limit {PRESENT_RGB_SHARE}), largest rgb gap {fig['rgb_max']}")
        if not ok:
            raise AssertionError(f"present_tpu {w}x{h} card vs CPU: {fig}")
    img_g, _ = gpu_soft.render_frame(runner, None, width=480, height=270)
    img_c, _ = gpu_soft.render_frame(cpu_runner, None, width=480, height=270)
    soft_gap = int(np.abs(img_g.astype(np.int32) - img_c.astype(np.int32)).max())
    gaps["soft"] = soft_gap
    log(f"[11 present] present() 480x270 card vs CPU (host raster, passes on each device): "
        f"largest u8 gap {soft_gap} (limit {SOFT_LEVELS})")
    if soft_gap > SOFT_LEVELS:
        raise AssertionError(f"software present card vs CPU: {soft_gap} levels")
    out["gaps"] = gaps
    return out


# -- 12. load and save: the world blob, checkpoints, the .unv importer and writer --------


def _lua_slots(world):
    """The device slots of the entities the scripts move (their Lua state
    is in no world blob, in either package)."""
    import numpy as np

    sm = world.modules["script"]
    ents = np.asarray(sorted(sm.lua_envs), np.int64)
    return world.to_slots(ents) if len(ents) else ents


def _branch(pm) -> str:
    st = pm.statics()
    return ("banded" if st.banded else "sap" if st.sap else "pruned" if st.pruned
            else "all-pairs")


def reload_gap(got, ref, lua_slots, mi_lua):
    """Two states of one world (state_to_numpy dicts) field by field, the
    entities the Lua scripts move left out of the transforms and of the
    renderer's previous poses: {field: largest abs difference} of the fields
    that differ."""
    import numpy as np

    gaps = {}
    for k, r in ref.items():
        if k.startswith("modules.script.") or k not in got:
            continue
        g = got[k]
        if k.split(".")[0] in ("local", "world") and len(lua_slots):
            keep = np.ones(g.shape[-1], bool)
            keep[lua_slots] = False
            g, r = g[..., keep], r[..., keep]
        elif k in ("modules.renderer.prev_pos", "modules.renderer.prev_rot") and len(mi_lua):
            keep = np.ones(g.shape[-1], bool)
            keep[mi_lua] = False
            g, r = g[..., keep], r[..., keep]
        if g.shape != r.shape or not np.array_equal(g, r):
            gaps[k] = (float(np.abs(g.astype(np.float64) - r.astype(np.float64)).max())
                       if g.shape == r.shape else float("inf"))
    return gaps


def run_host_tier(dev, card):
    """Phase 12: the stress scene (models/host_scenes.stress_scene: 2,048
    entities in a three-level hierarchy, 64 dynamic boxes and spheres over
    a static slab, 8 point lights and a camera, 16 animables, a nav zone
    whose guid names a packed .nav and 32 agents, 4 GUI rects with a core
    signal, 2 ambient sounds, 8 inline Lua scripts, one spawning a model
    instance with createEntityEx) written with the port's write_unv, then:
    Runner.load_world on the card and start (host clock); HOST_TICKS ticks
    with the launch counts (K1 and K2 once a tick); the same load and 3
    ticks on the CPU against the card (physics_scenes.state_gap,
    explain_break); serialize_world → serialize.load_world into a fresh
    engine (the scene's assets loaded), its snapshot bit for bit against
    the original's and HOST_RELOAD_TICKS ticks of both, field by field; a
    checkpoint at tick HOST_CKPT_AT resumed bit for bit; export_scene →
    write_unv → parse_unv against the scene; metrics(phases=True) after the
    ticks, beside each phase's device time; K2 against its plain version on
    the path's contact set. Returns the launch counts, K1's check and K2's record."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lumixengine_tpu_torch import app, bridge
    from lumixengine_tpu_torch.engine import serialize as ser
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.importers import instantiate as inst_mod
    from lumixengine_tpu_torch.importers import unv as U
    from lumixengine_tpu_torch.importers import unv_write as UW
    from lumixengine_tpu_torch.models import host_scenes as H
    from lumixengine_tpu_torch.ops import hierarchy as hier

    dev = torch.device(dev)
    out = {}
    tmp = tempfile.mkdtemp(prefix="host_tier_")
    try:
        scene = H.stress_scene(entities=HOST_ENTITIES, bodies=HOST_BODIES)
        H.write_stress_nav(tmp)
        path = os.path.join(tmp, "stress.unv")
        t0 = time.perf_counter()
        UW.save_unv(scene, path)
        write_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        # 1. the load and the start on the card
        runner = app.Runner([], engine=app.create_full_engine(base_path=tmp, device=dev))
        t0 = time.perf_counter()
        runner.load_world(path)
        load_s = time.perf_counter() - t0
        world, pm = runner.world, runner.world.modules["physics"]
        t0 = time.perf_counter()
        runner.start()
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        zone = world.modules["navigation"].zone
        log(f"[12 load] {card}: stress.unv ({size} bytes: {len(scene['entities'])} entities, "
            f"{len(scene['renderer']['model_instances'])} model instances, "
            f"{len(scene['physics']['actors'])} actors) written in {write_ms:.1f} ms; "
            f"Runner.load_world on {runner.device} {load_s:.3f} s, start {start_s:.3f} s on the "
            f"host's clock; {world.entity_count} entities after start; nav zone from the .nav "
            f"{zone.from_navmesh} (walkable {float(zone.walkable.mean()):.4f}); physics branch "
            f"{_branch(pm)}")
        if not zone.from_navmesh or runner.engine.device != dev:
            raise AssertionError(f"load: navmesh {zone.from_navmesh}, device {runner.engine.device}")
        # 2. HOST_TICKS ticks, the launch counts set to 0 just before and read just after
        states, tick_ms = [runner.state], []
        torch.cuda.synchronize()
        _zero_launches()
        for i in range(HOST_TICKS):
            t0 = time.perf_counter()
            runner.tick()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if i < 3 or i + 1 == HOST_CKPT_AT:
                states.append(runner.state)
        launches = _launches()
        ms = sorted(tick_ms[1:])
        finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(runner.state))
        contacts = int(runner.state.modules["physics"].counters["active_contacts"].sum())
        log(f"[12 ticks] {card}: {HOST_TICKS} Runner ticks (host clock, a sync each tick): the "
            f"first {tick_ms[0]:.3f} ms (it rebuilds the step after the spawn), the other "
            f"{len(ms)} median {ms[len(ms) // 2]:.3f} ms a tick, spread {ms[-1] - ms[0]:.3f} ms "
            f"(min {ms[0]:.3f}, max {ms[-1]:.3f}); launches {launches}, finite {finite}, active "
            f"contacts at the end {contacts}")
        if not _launched(launches, HOST_TICKS, HOST_TICKS) or not finite or contacts == 0:
            raise AssertionError(f"host tier ticks: launches {launches}, finite {finite}, "
                                 f"contacts {contacts}")
        out.update(launches=launches, tick_ms=tick_ms, load_s=load_s, start_s=start_s)
        # the phase model on the card (on the state after the ticks, the frame time their
        # average) beside each phase's device time
        t0 = time.perf_counter()
        m = runner.metrics(phases=True)
        prof_s = time.perf_counter() - t0
        dt = torch.tensor(DT, dtype=torch.float32, device=dev)
        st, rm = runner.state, world.modules["renderer"]
        rows = []
        for key, c in runner._phase_profile.items():
            mname, phase = key.split(".")
            if key == "world.propagate":
                fn = (lambda: hier.propagate_plan(st.local, world.plan))
            elif key == "extra.cull":
                fn = (lambda: rm.cull_pass(st, dt))
            else:
                fn = (lambda f=getattr(world.modules[mname], phase): f(st, dt))
            ev_ms, dev_ms = layer_time(fn, 5)
            rows.append(f"{key} est {m.get(f'phase.{key}.est_ms', 0.0):.4f} ms (frac "
                        f"{c['frac']:.4f}, {c['bytes']:.4g} B, {c['flops']:.4g} flop) | device "
                        f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms, events {ev_ms:.4f}")
        fsum = sum(v for k, v in m.items() if k.endswith(".frac"))
        log(f"[12 phases] {card}: metrics(phases=True) in {prof_s:.2f} s, frame_ms "
            f"{m.get('frame_ms')}, fractions sum {fsum:.4f}; " + "; ".join(rows))
        if abs(fsum - 1.0) > 1e-2:
            raise AssertionError(f"phase fractions sum to {fsum}")
        out["k1"] = k1_on_state("12 host tier", world, runner.state)
        # 3. the same load and 3 ticks on the CPU, against the card's first 3
        cpu = app.Runner([], engine=app.create_full_engine(base_path=tmp, device="cpu"))
        cpu.load_world(path)
        cpu.start()
        cstates = [cpu.state]
        for _ in range(3):
            cpu.tick()
            cstates.append(cpu.state)
        errs, breaks = card_vs_cpu(runner, pm, cpu.world.modules["physics"], states, cstates,
                                   dev, "host tier")
        shown = {k: float(f"{v:.3g}") for k, v in errs.items() if v}
        log(f"[12 cpu] the same load and 3 ticks on the CPU, card vs CPU: max abs err {shown} "
            f"(bodies {BODY_POS_ATOL:g} m / {BODY_VEL_ATOL:g} m/s, transforms and agents "
            f"{NAV_ATOL:g}); breaks explained {breaks}")
        out["cpu"] = {"errs": shown, "breaks": breaks}
        del cpu, cstates
        # 4. the world blob: serialize, load into a fresh engine, snapshot, 10 ticks of both
        t0 = time.perf_counter()
        blob = ser.serialize_world(world)
        ser_ms = (time.perf_counter() - t0) * 1e3
        codec = ser.blob_codec(blob)
        fresh = inst_mod.load_world(path, data_dirs=(tmp,), device=dev, base_path=tmp)
        fresh.assets.model_id("models/spawned.fbx")   # the model the spawner registered
        t0 = time.perf_counter()
        world2 = ser.load_world(fresh.engine, blob)
        de_ms = (time.perf_counter() - t0) * 1e3
        runner2 = app.Runner([], engine=fresh.engine)
        runner2.use_world(world2)
        runner2.start()
        snap1 = bridge.state_to_numpy(world.device_state(dev))
        snap2 = bridge.state_to_numpy(runner2.state)
        only1 = sorted(set(snap1) - set(snap2))
        lua_slots = _lua_slots(world)
        mi_lua = np.nonzero(np.isin(rm.model_instances.entity,
                                    sorted(world.modules["script"].lua_envs)))[0]
        snap_gap = reload_gap(snap2, snap1, [], [])
        log(f"[12 blob] {card}: serialize_world {ser_ms:.1f} ms ({len(blob)} bytes, codec "
            f"{codec}), serialize.load_world into a fresh engine {de_ms:.1f} ms; the snapshot "
            f"against the original's: fields that differ {snap_gap}, fields only the original "
            f"has {only1} (the Lua scripts' device rows: a world blob carries no Lua script, "
            f"in either package)")
        if codec != "lz4n" or snap_gap or any(not k.startswith("modules.script.") for k in only1):
            raise AssertionError(f"blob reload: codec {codec}, gaps {snap_gap}, only {only1}")
        step1 = runner.engine.build_step(world, dev, extra=rm.cull_pass)
        s1, s2 = world.device_state(dev), runner2.state
        for _ in range(HOST_RELOAD_TICKS):
            s1, s2 = step1(s1, DT), runner2.step(s2, DT)
        tick_gap = reload_gap(bridge.state_to_numpy(s2), bridge.state_to_numpy(s1),
                              lua_slots, mi_lua)
        # the audio listener is a module attribute, not a stored component: a world blob
        # does not carry it (in either package), and the sounds' gains and pans follow it
        listener = (world.modules["audio"].listener_entity,
                    world2.modules["audio"].listener_entity)
        unheld = {k: v for k, v in tick_gap.items()
                  if k.startswith("modules.audio.") and listener[0] >= 0 > listener[1]}
        held = {k: v for k, v in tick_gap.items() if k not in unheld}
        log(f"[12 blob] {HOST_RELOAD_TICKS} steps of the original world and of the reloaded "
            f"one from their snapshots, field by field (the {len(lua_slots)} entities the Lua "
            f"scripts move left out): fields that differ {held} (held to {BODY_POS_ATOL:g}); "
            f"not held, the audio listener (entity {listener[0]} before, {listener[1]} after "
            f"the reload) not being in the blob: {unheld}")
        if any(not v <= BODY_POS_ATOL for v in held.values()):
            raise AssertionError(f"blob reload: after {HOST_RELOAD_TICKS} steps {held}")
        out["blob"] = {"bytes": len(blob), "codec": codec, "serialize_ms": ser_ms,
                       "load_ms": de_ms, "tick_gap": held, "unheld": unheld}
        del runner2, world2, fresh
        # 5. a checkpoint at tick HOST_CKPT_AT, resumed for HOST_CKPT_AT ticks from both
        ckpt = os.path.join(tmp, "sim.ckpt")
        t0 = time.perf_counter()
        ser.save_checkpoint(states[-1], ckpt)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        restored = ser.load_checkpoint(ckpt, world.device_state(dev))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        a, b = states[-1], restored
        for _ in range(HOST_CKPT_AT):
            a, b = runner.step(a, DT), runner.step(b, DT)
        ga, gb = bridge.state_to_numpy(a), bridge.state_to_numpy(b)
        unequal = sorted(k for k in ga if not np.array_equal(ga[k], gb[k]))
        log(f"[12 checkpoint] {card}: save_checkpoint at tick {HOST_CKPT_AT} {save_ms:.1f} ms "
            f"({os.path.getsize(ckpt)} bytes), load_checkpoint {load_ms:.1f} ms; "
            f"{HOST_CKPT_AT} steps from the state and from the checkpoint: fields not bit-equal "
            f"{unequal}")
        if unequal:
            raise AssertionError(f"checkpoint resume is not bit-equal: {unequal}")
        out["checkpoint"] = {"save_ms": save_ms, "load_ms": load_ms}
        # 6. export_scene → write_unv → parse_unv against the scene
        fresh = inst_mod.load_world(path, data_dirs=(tmp,), device=dev, base_path=tmp)
        t0 = time.perf_counter()
        exported = inst_mod.export_scene(fresh)
        exported.pop("_export_new_entities")
        exported.pop("_export_new_components")
        again = U.parse_unv(UW.write_unv(exported))
        export_ms = (time.perf_counter() - t0) * 1e3
        diff = H.scene_diff(again, U.parse_unv(UW.write_unv(scene)))
        log(f"[12 export] {card}: export_scene → write_unv → parse_unv {export_ms:.1f} ms: "
            f"first difference from the scene {diff}")
        if diff is not None:
            raise AssertionError(f"export: the scene comes back different at {diff}")
        del fresh
        # K2 on the path's own contact set, as a batch of one world
        out["k2"] = k2_on_state(pm, map_tensors(lambda t: t[None], runner.state), "the host tier")
        log(f"[12 K2] {card}: on the path's contact set W={out['k2']['W']} NB={out['k2']['NB']} "
            f"C={out['k2']['C']} active {out['k2']['active']}: max abs err vs plain "
            f"{out['k2']['max_abs_err']:.3e}, {out['k2']['ms']:.4f} ms (plain "
            f"{out['k2']['plain_ms']:.4f} ms, bound {out['k2']['bound_ms']:.6f} ms over "
            f"{out['k2']['bytes']} bytes, share {out['k2']['share_of_bound']:.4f})")
        runner.shutdown()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def card_vs_cpu(runner, pm, cpm, states, cstates, dev, label):
    """The card's states after each tick against the CPU's from one load
    (states[0] and cstates[0] the started states; as many ticks as the CPU
    ran): the bodies within
    BODY_POS_ATOL and BODY_VEL_ATOL with a break explained at its contact
    decision (physics_scenes.state_gap, explain_break), the agents within
    NAV_ATOL, the skinned poses and palettes within POSE_ATOL. Returns
    ({field: largest abs difference}, [(tick, cause, margin)])."""
    import numpy as np

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS

    errs, breaks = {}, []

    def gap(got, ref):
        return PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)[:2]

    held = {"modules.navigation.agent_pos": NAV_ATOL, "modules.navigation.agent_vel": NAV_ATOL,
            "modules.animation.pose_pos": POSE_ATOL, "modules.animation.pose_rot": POSE_ATOL,
            "modules.animation.palette": POSE_ATOL}
    for f in range(1, len(cstates)):
        got, ref = bridge.state_to_numpy(states[f]), bridge.state_to_numpy(cstates[f])
        if set(got) != set(ref):
            raise AssertionError(f"card and CPU states differ in fields: "
                                 f"{sorted(set(got) ^ set(ref))}")
        e, broke, _ = PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)
        if broke is not None:
            prev = bridge.state_to_numpy(cstates[f - 1])
            drift = max(gap(bridge.state_to_numpy(states[f - 1]), prev)[0].values())
            cause, margin, e = PS.explain_break(
                runner.step, cstates[f - 1].to(dev), ref, gap, drift, pm,
                lambda c=cstates[f - 1]: cpm._contact_stage(c, DT).contacts)
            breaks.append((f, f"{cause} ({broke})", float(f"{margin:.3g}")))
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        for k, atol in held.items():
            if k in got and got[k].size:
                d = float(np.abs(got[k].astype(np.float64) - ref[k].astype(np.float64)).max())
                errs[k] = max(errs.get(k, 0.0), d)
                if not d <= atol:
                    raise AssertionError(f"{label} card vs CPU: {k} {d} (limit {atol})")
    return errs, breaks


# -- 13. real assets and the terminal: the codecs, the asset compiler, the editor's views ----


def _bind_anm(runner, blob):
    """The compiled take (an .anm blob) decoded onto the loaded character's
    skeleton, added to the clip bank and bound to the first animable, before
    the Runner starts. Returns (clip id, the animable's entity)."""
    import numpy as np

    from lumixengine_tpu_torch.importers import anm
    from lumixengine_tpu_torch.models import asset_scenes as A

    world = runner.world
    models = world.modules["renderer"].system.models
    sk = models.get(models.get_id(A.CHARACTER)).skeleton
    am = world.modules["animation"]
    cid = am.system.add_clip(anm.load_clip(blob, sk.bone_names, sk.bind_pos, sk.bind_rot,
                                           name=A.ANM))
    e = int(am.animables.entity[np.nonzero(am.animables.entity >= 0)[0][0]])
    world.destroy_component(e, "animable")
    world.create_component(e, "animable", clip=cid)
    return cid, e


def _close_view(runner, entity, back=4.0, up=1.0):
    """The runner's state with its camera (which looks down -z, as the
    scene's does) `back` m in front of and `up` m above `entity`, stepped
    once at dt 0 so that the transforms and the cull output follow it."""
    import torch

    st = runner.state
    cam = int(runner.world.modules["renderer"].statics().cam_slots[0])
    e = int(runner.world.to_slots([entity])[0])
    pos = st.local.pos.clone()
    pos[:, cam] = st.world.pos[:, e] + torch.tensor([0.0, up, back], device=pos.device)
    moved = st.replace(local=st.local.replace(pos=pos))
    return runner.step(moved, torch.zeros((), dtype=torch.float32, device=pos.device))


def run_asset_tier(dev, card):
    """Phase 13: the assets of models/asset_scenes.py (the skinned character
    at the reference's "Y bot" size with its 1 s take, a box, a sphere and a
    rock with their .fbx.meta sidecars, a .mat, an .ltc graph, the take as
    an .anm) and asset_stress_scene (phase 12's stress scene on them)
    written into a temporary data dir, then: each FBX parsed (load_fbx,
    to_model, to_clip) on the host's clock; the .fbx with its .meta, the
    .anm, the .mat and the .ltc compiled through an AssetCompiler attached
    to the engine, the .mat rewritten and recompiled by one
    Engine.update_host; Runner.load_world on the card with every FBX path a
    real model and the take a real clip (no placeholder), the .anm's clip
    bound to one animable; ASSET_TICKS ticks with K1 and K2 counted and the
    device-busy share; 3 ticks card vs CPU from one load (the skinned poses
    and palettes included); present_tpu at ASSET_PRESENT with the FBX
    meshes skinned on the card, card vs CPU; the game view (play,
    ASSET_EDITOR_FRAMES tick_frames, stop) restoring the world bit for bit
    outside the rows a blob does not carry; the animation graph editor's
    preview on an .act of the take, the particle editor's preview on the
    card and on the CPU (equal live counts), the voxelizer on the
    character; app.main --tui on the .unv with its output in a buffer.
    Returns the launch counts, K1's check and K2's record."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lumixengine_tpu_torch import app, bridge
    from lumixengine_tpu_torch.editor.anim_editor import AnimGraphEditor
    from lumixengine_tpu_torch.editor.asset_compiler import AssetCompiler
    from lumixengine_tpu_torch.editor.game_view import GameView
    from lumixengine_tpu_torch.editor.particle_editor import ParticleEditor
    from lumixengine_tpu_torch.editor.voxelizer_ui import VoxelizerUI
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.importers import anm
    from lumixengine_tpu_torch.importers import composite_texture as CT
    from lumixengine_tpu_torch.importers import fbx
    from lumixengine_tpu_torch.importers import instantiate as inst_mod
    from lumixengine_tpu_torch.importers import mat, model_meta
    from lumixengine_tpu_torch.importers import unv_write as UW
    from lumixengine_tpu_torch.models import asset_scenes as A
    from lumixengine_tpu_torch.models import host_scenes as H
    from lumixengine_tpu_torch.renderer import gpu_tpu

    dev = torch.device(dev)
    out = {}
    steps = [("start", time.perf_counter())]   # each step's end on the host's clock
    tmp = tempfile.mkdtemp(prefix="asset_tier_")
    try:
        # 1. write the assets and the scene
        t0 = time.perf_counter()
        files = A.write_assets(tmp)
        H.write_stress_nav(tmp)
        act_rel = "anims/character.act"
        os.makedirs(os.path.join(tmp, "anims"))
        with open(os.path.join(tmp, act_rel), "wb") as f:
            f.write(A.act_bytes(A.CHARACTER, f".ani:{A.CHARACTER}"))
        scene = A.asset_stress_scene(entities=ASSET_ENTITIES, bodies=ASSET_BODIES)
        path = os.path.join(tmp, "assets.unv")
        UW.save_unv(scene, path)
        write_s = time.perf_counter() - t0
        full = {k: os.path.join(tmp, v) for k, v in files.items()}
        named = {mi["model"] for mi in scene["renderer"]["model_instances"]}
        log(f"[13 write] assets and scene written in {write_s:.2f} s (host clock): "
            f"{A.CHARACTER} {os.path.getsize(full['character'])} bytes, {A.ANM} "
            f"{os.path.getsize(full['anm'])} bytes, assets.unv {os.path.getsize(path)} bytes "
            f"({len(scene['entities'])} entities, {len(scene['renderer']['model_instances'])} "
            f"model instances on {len(named)} FBX files, {len(scene['physics']['actors'])} "
            f"actors)")
        steps.append(("write", time.perf_counter()))
        # 2. parse each FBX on the host's clock
        parsed = []
        for key in ("character", "box", "sphere", "rock"):
            t0 = time.perf_counter()
            doc = fbx.load_fbx(full[key])
            t1 = time.perf_counter()
            model = fbx.to_model(doc, name=files[key])
            t2 = time.perf_counter()
            row = (f"{key} load_fbx {(t1 - t0) * 1e3:.1f} ms, to_model {(t2 - t1) * 1e3:.1f} ms "
                   f"({len(model.vertex_positions)} vertices, {len(model.vertex_triangles)} "
                   f"triangles)")
            if key == "character":
                t0 = time.perf_counter()
                take = fbx.to_clip(doc, model.skeleton, name=files[key])
                clip_ms = (time.perf_counter() - t0) * 1e3
                sk = model.skeleton
                row += (f", to_clip {clip_ms:.1f} ms ({take.pos.shape[0]} frames at "
                        f"{take.fps:g} fps); "
                        f"{sk.bone_count} bones from {sk.bone_names[0]}")
                if sk.bone_count != 52 or len(model.vertex_positions) < 20_000:
                    raise AssertionError(f"character: {sk.bone_count} bones, "
                                         f"{len(model.vertex_positions)} vertices")
            parsed.append(row)
        log("[13 parse] " + "; ".join(parsed))
        steps.append(("parse", time.perf_counter()))
        # 3. the asset compiler attached to the engine
        runner = app.Runner([], engine=app.create_full_engine(base_path=tmp, device=dev))
        t0 = time.perf_counter()
        runner.load_world(path)
        load_s = time.perf_counter() - t0
        ac = AssetCompiler()
        model_meta.register(ac)
        mat.register(ac)
        CT.register(ac, load_texture=A.texture_loader())
        ac.add_plugin("anm", lambda p, src: anm.decode_anm(src))
        runner.engine.asset_compiler = ac
        comp = {}
        for key in ("rock", "anm", "mat", "ltc"):
            t0 = time.perf_counter()
            comp[key] = ac.compile(full[key])
            comp[key + "_ms"] = (time.perf_counter() - t0) * 1e3
        takes = AssetCompiler()    # the take's plugin also keys on .fbx
        anm.register(takes)
        with open(full["anm"], "rb") as f:
            anm_blob = f.read()
        fresh_take = anm.decode_anm(takes.compile(full["character"])["character"])
        written = comp["anm"]
        same_anm = all(getattr(fresh_take, k) == getattr(written, k) for k in (
            "samples", "translation_stream", "rotation_stream"))
        hull = comp["rock"]["physics"]
        v0 = ac.version(full["mat"])
        with open(full["mat"], "w") as f:
            f.write(A.MAT_TEXT.replace('"Metallic", 0.125', '"Metallic", 0.25'))
        st = os.stat(full["mat"])
        os.utime(full["mat"], (st.st_atime, st.st_mtime + 1.0))
        runner.engine.update_host(DT)
        v1 = ac.version(full["mat"])
        recompiled = mat.parse_mat(ac.get(full["mat"]))
        log(f"[13 compile] {A.PROPS['rock']} with its .meta {comp['rock_ms']:.1f} ms (origin "
            f"{comp['rock']['meta'].origin}, {comp['rock']['meta'].lod_count} LODs, physics "
            f"{hull[0]}: {hull[1].n_verts} hull vertices, {hull[1].n_faces} face axes), "
            f"{A.ANM} {comp['anm_ms']:.1f} ms "
            f"({comp['anm'].samples} samples), {A.MAT} {comp['mat_ms']:.1f} ms, {A.LTC} "
            f"{comp['ltc_ms']:.1f} ms ({len(comp['ltc']['layers'])} layers); the take compiled "
            f"from the .fbx by the .anm plugin has the written .anm's bit-packed tracks: "
            f"{same_anm}; the .mat rewritten: "
            f"one Engine.update_host recompiled it, version {v0} -> {v1}, Metallic "
            f"{recompiled.uniforms.get('Metallic')}")
        if (v1 != v0 + 1 or recompiled.uniforms.get("Metallic") != 0.25 or not same_anm
                or hull[0] != "convex"):
            raise AssertionError(f"asset compiler: version {v0} -> {v1}, .anm equal {same_anm}, "
                                 f"physics {hull[0]}")
        steps.append(("load and compile", time.perf_counter()))
        # 4. the load on the card: no placeholder
        rep = dict(runner.world.modules["script"].asset_bank().report)
        log(f"[13 load] {card}: Runner.load_world on {runner.device} {load_s:.3f} s (host clock); "
            f"assets {rep}")
        if (rep.get("model_fbx") != len(named) or rep.get("clip_fbx", 0) < 1
                or rep.get("model_placeholder", 0) or rep.get("clip_placeholder", 0)):
            raise AssertionError(f"asset tier load: {rep} for {len(named)} FBX paths")
        cid, bound_e = _bind_anm(runner, anm_blob)
        t0 = time.perf_counter()
        runner.start()
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        steps.append(("bind and start", time.perf_counter()))
        # 5. ASSET_TICKS ticks, the launch counts set to 0 just before and read just after
        states, tick_ms = [runner.state], []
        torch.cuda.synchronize()
        _zero_launches()
        for i in range(ASSET_TICKS):
            t0 = time.perf_counter()
            runner.tick()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if i < 3:
                states.append(runner.state)
        launches = _launches()
        ms = sorted(tick_ms[1:])
        world, pm = runner.world, runner.world.modules["physics"]
        st = runner.state
        finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(st))
        log(f"[13 ticks] {card}: start {start_s:.3f} s; {ASSET_TICKS} Runner ticks (host clock, a "
            f"sync each tick): the first {tick_ms[0]:.3f} ms, the other {len(ms)} median "
            f"{ms[len(ms) // 2]:.3f} ms a tick, spread {ms[-1] - ms[0]:.3f} ms (min {ms[0]:.3f}, "
            f"max {ms[-1]:.3f}); launches {launches}, finite {finite}; the .anm clip {cid} on "
            f"entity {bound_e}")
        if not _launched(launches, ASSET_TICKS, ASSET_TICKS) or not finite:
            raise AssertionError(f"asset tier ticks: launches {launches}, finite {finite}")
        # the frame alone: phase 12 times each module phase of the same scene
        busy = device_busy(runner.step, st, {}, label="13 device")
        out.update(launches=launches, tick_ms=tick_ms, load_s=load_s, start_s=start_s, busy=busy)
        out["k1"] = k1_on_state("13 asset tier", world, st)
        steps.append(("ticks", time.perf_counter()))
        # 6. the same load and 3 ticks on the CPU, against the card's first 3
        cpu = app.Runner([], engine=app.create_full_engine(base_path=tmp, device="cpu"))
        cpu.load_world(path)
        _bind_anm(cpu, anm_blob)
        cpu.start()
        cstates = [cpu.state]
        for _ in range(3):
            cpu.tick()
            cstates.append(cpu.state)
        errs, breaks = card_vs_cpu(runner, pm, cpu.world.modules["physics"], states, cstates,
                                   dev, "asset tier")
        shown = {k: float(f"{v:.3g}") for k, v in errs.items() if v}
        log(f"[13 cpu] the same load and 3 ticks on the CPU, card vs CPU: max abs err {shown} "
            f"(bodies {BODY_POS_ATOL:g} m / {BODY_VEL_ATOL:g} m/s, agents {NAV_ATOL:g}, poses "
            f"and palettes {POSE_ATOL:g}); breaks explained {breaks}")
        out["cpu"] = {"errs": shown, "breaks": breaks}
        del cpu, cstates
        steps.append(("cpu", time.perf_counter()))
        # 7. the on-device present of the FBX meshes from the scene's camera and from a close
        # view of the character the .anm drives (one soup, baked once), the close view card vs
        # CPU: it covers a quarter of the image, the scene's camera a thousandth
        w, h = ASSET_PRESENT
        out["present"] = {}
        tp = gpu_tpu.TpuPresent(w, h)
        shown = app.Runner([], engine=runner.engine)
        shown.use_world(world)
        for view, vstate in (("world camera", st), ("close", _close_view(runner, bound_e))):
            shown.state = vstate
            rgb, depth, ov = tp(shown)
            p_ms, p_spread = event_times(lambda: tp(shown), PRESENT_WARM, PRESENT_REPS)
            fill = float(torch.isfinite(depth).float().mean())
            row = (f"[13 present] {card}: present_tpu {w}x{h}, {view}, of the FBX meshes "
                   f"({len(tp.soup.tri)} soup triangles, the characters skinned on the card): "
                   f"{p_ms:.3f} ms a present (CUDA events, median of {PRESENT_REPS} after "
                   f"{PRESENT_WARM} warm, spread {p_spread:.3f} ms), overflow {int(ov)}, "
                   f"{fill:.4f} of the pixels hit")
            out["present"][view] = {"ms": p_ms, "spread": p_spread, "overflow": int(ov),
                                    "soup_tris": len(tp.soup.tri), "hit": fill}
            if view == "close":
                shown.state = map_tensors(lambda x: x.cpu(), vstate)
                fig, ok = present_gap((rgb.cpu().numpy(), depth.cpu().numpy(), int(ov)),
                                      gpu_tpu.TpuPresent(w, h)(shown))
                row += (f"; card vs CPU: overflow {fig['overflow']}, hit masks agree on "
                        f"{fig['coverage']:.6f} (limit {PRESENT_COVERAGE_MIN}), depth "
                        f"{fig['depth_rel']:.3e} relative (limit {PRESENT_DEPTH_RTOL:g}), rgb "
                        f"within {PRESENT_RGB_LEVELS} level on {fig['rgb_share']:.6f} (limit "
                        f"{PRESENT_RGB_SHARE}), largest rgb gap {fig['rgb_max']}")
                out["present"][view]["gap"] = fig
                if not ok:
                    raise AssertionError(f"asset present, {view}, card vs CPU: {fig}")
            log(row)
            if not fill > 0:
                raise AssertionError(f"asset present, {view}: no pixel hit")
        del shown, tp
        runner.shutdown()
        steps.append(("present", time.perf_counter()))
        # 8. the game view on a fresh load: play, tick_frame, stop
        fresh = inst_mod.load_world(path, data_dirs=(tmp,), device=dev, base_path=tmp)
        replaced = []
        gv = GameView(fresh.engine, fresh.world, replaced.append)
        before = bridge.state_to_numpy(fresh.world.device_state(dev))
        gv.toggle_play()
        t0 = time.perf_counter()
        for _ in range(ASSET_EDITOR_FRAMES):
            gv.tick_frame()
        torch.cuda.synchronize()
        play_ms = (time.perf_counter() - t0) * 1e3 / ASSET_EDITOR_FRAMES
        played = bridge.state_to_numpy(gv.runner().state)
        gv.toggle_play()
        after = bridge.state_to_numpy(gv.world.device_state(dev))
        moved = int(played["frame"]) == ASSET_EDITOR_FRAMES
        unheld = sorted(k for k in set(before) | set(after) if k.startswith(BLOB_UNCARRIED))
        live = before["modules.renderer.mi_entity"] >= 0

        def held(snap):
            return {k: v[..., live] if k.startswith(INSTANCE_ROWS) else v
                    for k, v in snap.items() if k not in unheld}

        gaps = reload_gap(held(after), held(before), [], [])
        if not np.array_equal(after["modules.renderer.mi_entity"],
                              before["modules.renderer.mi_entity"]):
            gaps["modules.renderer.mi_entity"] = float("inf")
        only = sorted((set(before) ^ set(after)) - set(unheld))
        log(f"[13 game view] {card}: play, {ASSET_EDITOR_FRAMES} tick_frames "
            f"{play_ms:.3f} ms a frame (host clock), the game at frame {int(played['frame'])}, "
            f"stop: on_world_replaced {len(replaced)}, restored snapshot against the pre-play one: "
            f"fields that differ {gaps}, fields in one only {only}; not held, the rows a world "
            f"blob does not carry ({', '.join(BLOB_UNCARRIED)}): {len(unheld)} fields, and the "
            f"{int((~live).sum())} free model-instance slots")
        if gaps or only or len(replaced) != 1 or not moved:
            raise AssertionError(f"game view restore: gaps {gaps}, only {only}, replaced "
                                 f"{len(replaced)}, frame {int(played['frame'])}")
        out["game_view"] = {"ms": play_ms}
        steps.append(("game view", time.perf_counter()))
        # 9. the editors: the animation graph, the particle script, the voxelizer
        ctrl_id = fresh.assets.controller_id(act_rel, A.CHARACTER)
        if fresh.assets.report["controller_act"] != 1:
            raise AssertionError(f"the take's .act did not load: {dict(fresh.assets.report)}")
        ed = AnimGraphEditor(fresh.assets.anim.controllers[ctrl_id], device=dev)
        t0 = time.perf_counter()
        for _ in range(ASSET_EDITOR_FRAMES):
            ed.step_preview()
        anim_ms = (time.perf_counter() - t0) * 1e3 / ASSET_EDITOR_FRAMES
        pat = os.path.join(tmp, "particles", "sparks.pat")
        os.makedirs(os.path.dirname(pat))
        with open(pat, "w") as f:
            f.write(A.PAT_TEXT)
        pe, pe_cpu = ParticleEditor(pat, device=dev), ParticleEditor(pat, device="cpu")
        t0 = time.perf_counter()
        pe.step_preview(ASSET_EDITOR_FRAMES)
        torch.cuda.synchronize()
        pat_ms = (time.perf_counter() - t0) * 1e3 / ASSET_EDITOR_FRAMES
        pe_cpu.step_preview(ASSET_EDITOR_FRAMES)
        t0 = time.perf_counter()
        vox = VoxelizerUI(model_path=full["character"])
        vox.compute_ao()
        vox.blur_ao()
        vox_ms = (time.perf_counter() - t0) * 1e3
        live = {n: hist[-1] for n, hist in pe.history.items()}
        log(f"[13 editors] {card}: AnimGraphEditor.step_preview on {act_rel} "
            f"{anim_ms:.3f} ms a frame (the first of {len(ed._last_slots)} slots "
            f"{ed._last_slots[0]}); ParticleEditor.step_preview({ASSET_EDITOR_FRAMES}) "
            f"{pat_ms:.3f} ms a frame, live at the end {live}, the same "
            f"preview on the CPU equal frame by frame {pe.history == pe_cpu.history}; VoxelizerUI "
            f"on the character (voxelize, AO, blur) {vox_ms:.1f} ms: {int(vox.grid.sum())} cells "
            f"at {vox.resolution}^3, AO mean {float(vox.ao.mean()):.4f}")
        if (pe.history != pe_cpu.history or not max(live.values()) > 0 or pe.error
                or not vox.grid.any() or not np.isfinite(ed.clocks).all()):
            raise AssertionError(f"editors: particle histories {pe.history} vs "
                                 f"{pe_cpu.history}, error {pe.error}, voxels "
                                 f"{int(vox.grid.sum())}, clocks {ed.clocks}")
        out["editors"] = {"anim_ms": anim_ms, "particle_ms": pat_ms, "voxel_ms": vox_ms}
        del fresh, gv, ed, pe, pe_cpu
        steps.append(("editors", time.perf_counter()))
        # 10. app.main --tui on the .unv, its output in a buffer (no tty)
        seen = {}
        run_tui = app._run_tui

        def timed_tui(r, frames):
            seen["device"] = r.device
            t = time.perf_counter()
            run_tui(r, frames)
            seen["ms"] = (time.perf_counter() - t) * 1e3 / frames

        buf = io.StringIO()
        cwd = os.getcwd()
        app._run_tui = timed_tui
        try:
            os.chdir(tmp)    # app.main's engine resolves assets against its base path, "."
            with contextlib.redirect_stdout(buf):
                rc = app.main(["--world", path, "--tui", "--frames", str(TUI_FRAMES)])
        finally:
            app._run_tui = run_tui
            os.chdir(cwd)
        text = buf.getvalue()
        ansi = text[text.find("\x1b[?1049h"):text.find("\x1b[?1049l") + len("\x1b[?1049l")]
        frames = ansi.count("\x1b[H")
        log(f"[13 tui] {card}: app.main --world assets.unv --tui --frames {TUI_FRAMES}: rc {rc}, "
            f"{frames} frames presented, {seen.get('ms', float('nan')):.1f} ms a TUI frame (host "
            f"clock: tick, present() at 320x180, ANSI), {len(ansi.encode())} bytes of ANSI, the "
            f"Runner on {seen.get('device')}")
        if rc != 0 or frames != TUI_FRAMES or getattr(seen.get("device"), "type", None) != dev.type:
            raise AssertionError(f"tui: rc {rc}, {frames} frames, device {seen.get('device')}")
        out["tui"] = {"ms": seen["ms"], "bytes": len(ansi.encode())}
        steps.append(("tui", time.perf_counter()))
        # K2 on the path's own contact set, as a batch of one world
        out["k2"] = k2_on_state(pm, map_tensors(lambda t: t[None], st), "the asset tier")
        log(f"[13 K2] {card}: on the path's contact set W={out['k2']['W']} NB={out['k2']['NB']} "
            f"C={out['k2']['C']} active {out['k2']['active']}: max abs err vs plain "
            f"{out['k2']['max_abs_err']:.3e}, {out['k2']['ms']:.4f} ms (plain "
            f"{out['k2']['plain_ms']:.4f} ms, bound {out['k2']['bound_ms']:.6f} ms over "
            f"{out['k2']['bytes']} bytes, share {out['k2']['share_of_bound']:.4f})")
        steps.append(("K2", time.perf_counter()))
        out["steps_s"] = {name: t - steps[k][1] for k, (name, t) in enumerate(steps[1:])}
        log(f"[13 time] the steps on the host's clock, s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in out["steps_s"].items()))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- 14. the editor: EditorApp on the stress scene, its views, the scene view's frames, the
# sharded step's dry run --


def editor_rows(world):
    """The host world as the editor edits it: entity rows, names and each
    module's component records."""
    import numpy as np

    from lumixengine_tpu_torch.engine import serialize as ser

    rows = {k: np.asarray(getattr(world, k)).copy()
            for k in ("alive", "parent", "local_pos", "local_rot", "local_scale")}
    rows["names"] = dict(world.names)
    rows["components"] = {n: ser._dump_module_components(m) for n, m in world.modules.items()}
    return rows


def editor_script(path, data_dir, dev, ini):
    """Phase 14's fixed key script through EditorApp.handle_key on the
    .unv at `path`, opened as `python -m lumixengine_tpu_torch.editor.app
    --world` opens it, on `dev`. Returns (app, record, times): `record` what
    the card and the CPU must agree on (screens, host rows, the scene view's
    states and paused images), `times` on the host's clock (ms)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.editor import app as editor_app
    from lumixengine_tpu_torch.editor.commands import AddComponentCommand

    UP, DOWN, LEFT, TAB, ENTER, ESC = 0x26, 0x28, 0x25, 9, 13, 27
    rec = {"screens": [], "states": [], "images": []}
    times = {"command": [], "undo": [], "redo": [], "render_text": [], "scene_frame": []}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def press(*keys, kind=None):
        t0 = time.perf_counter()
        for k in keys:
            if isinstance(k, int):
                app.handle_key(k)
            else:
                for ch in k:
                    app.handle_key(0, ch)
        sync()
        if kind:
            times[kind].append((time.perf_counter() - t0) * 1e3)

    def screen(label, width=100, height=28, keep=True):
        t0 = time.perf_counter()
        text = app.render_text(width, height)
        sync()
        times["render_text"].append((time.perf_counter() - t0) * 1e3)
        if keep:
            rec["screens"].append((label, text))
        return text

    def scene_frame(label):
        """A scene view frame through render_text at the view's 160x90, its
        state kept; a paused frame presented again for its image."""
        sv = app.scene_view()
        t0 = time.perf_counter()
        app.render_text(EDITOR_SCENE_TEXT[0], EDITOR_SCENE_TEXT[1])
        sync()
        times["scene_frame"].append((time.perf_counter() - t0) * 1e3)
        rec["states"].append((label, sv.runner().state))
        if not sv.playing:
            rec["images"].append((label, sv.frame()))

    t0 = time.perf_counter()
    app = editor_app.open_world(path, dev, settings_path=ini, data_dirs=(data_dir,))
    times["open_s"] = time.perf_counter() - t0
    world = app.world
    screen("opened")
    # select, a transform edit and a reflected property, a new entity destroyed
    press(DOWN, DOWN, DOWN)
    press(TAB, ENTER, "12.5", ENTER, kind="command")
    press(TAB)
    ents = app.entities()
    app.sel = next(i for i, (e, _) in enumerate(ents) if world.get_entity_name(e) == "light0")
    rows = app.prop_rows(app.selected_entity())
    app.panel = "props"
    app.prop_sel = next(i for i, (c, p, _v) in enumerate(rows) if (c, p) == ("point_light",
                                                                              "intensity"))
    press(ENTER, "3.5", ENTER, kind="command")
    press(TAB)
    press("n", kind="command")
    app.sel = next(i for i, (e, _) in enumerate(app.entities())
                   if world.get_entity_name(e) == "new entity")
    press("x", kind="command")
    screen("edited")
    rec["rows_edited"] = editor_rows(world)
    for _ in range(4):
        press("u", kind="undo")
    screen("undone")
    for _ in range(4):
        press("y", kind="redo")
    screen("redone")
    # a spline on the slab through the command stack, for the spline view
    slab = world.find_by_name("slab")
    app.stack.execute(AddComponentCommand(slab, "spline", points=[[0, 1, 0], [4, 1, 0],
                                                                  [8, 2, 2]]))
    # the views: 1 log, 2 assets, 3 profiler, 4 scene, 7 physics, 9 material, @ meta,
    # , settings, . spline, D dock
    press("1")
    screen("log", keep=False)
    press(ESC, "2")
    screen("assets")
    ab = app.asset_browser()
    ab.filter = "box.fbx"
    ab.sel = 0
    press("@")
    screen("meta")
    press(ESC, ESC, "3")
    screen("profiler", keep=False)
    press(ESC, "4")
    scene_frame("scene opened")
    press("w", "w", "a", LEFT)
    scene_frame("scene flown (dt = 0 step)")
    press("g")
    for i in range(EDITOR_PLAY_FRAMES):
        scene_frame(f"playing {i + 1}")
    press("g", ESC, "7")
    screen("physics joints")
    press("m", " ")           # the cursor's pair, layer 0 with layer 0: off
    screen("physics layers")
    press(ESC, "4", "g")
    for i in range(EDITOR_PLAY_FRAMES):
        scene_frame(f"playing after the layer edit {i + 1}")
    press("g", ESC, "9")
    screen("material")
    press(ESC, ",")
    screen("settings")
    press(ESC, ".")
    screen("spline")
    press("a", "l", "l")
    screen("spline edited")
    press(ESC, "D")
    screen("docked log", keep=False)
    press("D", "D")
    t0 = time.perf_counter()
    app.render_text(100, 40)            # the scene docked under the main view
    sync()
    times["render_text"].append((time.perf_counter() - t0) * 1e3)
    press("D")
    screen("dock closed")
    rec["rows"] = editor_rows(world)
    rec["states"] = [(label, bridge.state_to_numpy(s)) for label, s in rec["states"]]
    rec["layer_matrix"] = np.asarray(world.modules["physics"].system.layer_matrix).copy()
    return app, rec, times


def editor_gap(got, ref):
    """Card (`got`) against CPU (`ref`) records of editor_script: the
    screens equal, the host rows equal (their floats within BODY_POS_ATOL:
    the bodies' rows come back from the device when the scene view rebuilds
    its step), the paused images within SOFT_LEVELS, the
    scene view's states within phase 12's tolerances (state_gap: bodies
    BODY_POS_ATOL and BODY_VEL_ATOL, its exact fields equal). Returns the
    readings; raises on a difference."""
    import numpy as np

    from lumixengine_tpu_torch.models import physics_scenes as PS

    if [s for s, _t in got["screens"]] != [s for s, _t in ref["screens"]]:
        raise AssertionError("editor: the screens' sequence differs")
    unequal = [label for (label, a), (_l, b) in zip(got["screens"], ref["screens"]) if a != b]
    rows, row_err = [], 0.0
    for key in ("rows_edited", "rows"):
        for k, a in ref[key].items():
            b = got[key][k]
            if isinstance(a, np.ndarray) and a.dtype.kind == "f":
                # the bodies' rows come back from the device when the step is rebuilt
                d = float(np.abs(a - b).max(initial=0.0))
                row_err = max(row_err, d)
                same = d <= BODY_POS_ATOL
            else:
                same = (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
            if not same:
                rows.append(f"{key}.{k}")
    img = max((int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
               for (_l, a), (_m, b) in zip(got["images"], ref["images"])), default=0)
    errs, breaks = {}, []
    for (label, g), (_l, r) in zip(got["states"], ref["states"]):
        e, broke, _woke = PS.state_gap(g, r, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        if broke is not None:
            breaks.append((label, broke))
    if not np.array_equal(got["layer_matrix"], ref["layer_matrix"]):
        rows.append("layer_matrix")
    out = {"screens": len(got["screens"]), "screens_unequal": unequal, "rows_unequal": rows,
           "row_err": row_err,
           "images": len(got["images"]), "image_gap": img, "states": len(got["states"]),
           "errs": {k: float(f"{v:.3g}") for k, v in errs.items() if v}, "breaks": breaks}
    if unequal or rows or img > SOFT_LEVELS or breaks:
        raise AssertionError(f"editor, card vs CPU: {out}")
    return out


def run_editor_tier(dev, card):
    """Phase 14: phase 12's stress scene (models/host_scenes.py, EDITOR_ENTITIES
    entities, EDITOR_BODIES bodies, the pruned branch) written as a .unv
    beside the assets phase 13 writes, opened by the editor as
    `python -m lumixengine_tpu_torch.editor.app --world` opens it, on the
    card; editor_script's keys (edits, create, destroy, undo and redo each,
    every view, the scene view's paused dt = 0 frame and playing frames, a
    physics-view layer edit then play, docking), the launch counts set to 0
    just before and read just after; the world saved back as .unv and
    reloaded (its export equal to the edited world's); the same script on
    the CPU against the card (editor_gap); EDITOR_LAND_FRAMES more ticks on
    the card so that the bodies rest, then K1 and K2 against their plain
    versions on the path's own operands; and parallel/dryrun.py with
    EDITOR_DRYRUN_SHARDS shards on the card with its gap. Returns the
    launch counts, K1's check, K2's record and the dry run's."""
    import shutil
    import tempfile

    import torch

    from lumixengine_tpu_torch.editor import app as editor_app
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.importers import instantiate as inst_mod
    from lumixengine_tpu_torch.importers import unv_write as UW
    from lumixengine_tpu_torch.models import asset_scenes as A
    from lumixengine_tpu_torch.models import host_scenes as H
    from lumixengine_tpu_torch.parallel import dryrun

    dev = torch.device(dev)
    out = {}
    tmp = tempfile.mkdtemp(prefix="editor_tier_")
    try:
        A.write_assets(tmp)
        H.write_stress_nav(tmp)
        path = os.path.join(tmp, "stress.unv")
        UW.save_unv(H.stress_scene(entities=EDITOR_ENTITIES, bodies=EDITOR_BODIES), path)
        # 1. the key script on the card
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        ini = os.path.join(tmp, "editor.ini")       # read if present; the script writes none
        app, rec, times = editor_script(path, tmp, dev, ini)
        script_s = time.perf_counter() - t0
        launches = _launches()
        world, pm = app.world, app.world.modules["physics"]
        finite = all(bool(torch.isfinite(t).all())
                     for t in _float_tensors(app.scene_view().runner().state))

        def med(xs):
            xs = sorted(xs)
            return f"{xs[len(xs) // 2]:.3f} (min {xs[0]:.3f}, max {xs[-1]:.3f}, n {len(xs)})"

        # 2. the same script on the CPU, against the card (before anything is written
        # into the data dir the asset browser lists)
        t0 = time.perf_counter()
        _capp, crec, _ctimes = editor_script(path, tmp, torch.device("cpu"), ini)
        cpu_s = time.perf_counter() - t0
        gap = editor_gap(rec, crec)
        log(f"[14 cpu] the same key script on the CPU ({cpu_s:.2f} s): {gap['screens']} screens "
            f"equal string for string, host rows equal (floats within {gap['row_err']:.3g}), "
            f"{gap['images']} paused images within "
            f"{gap['image_gap']} u8 levels (limit {SOFT_LEVELS}), {gap['states']} scene view "
            f"states: max abs err {gap['errs']} (bodies {BODY_POS_ATOL:g} m / "
            f"{BODY_VEL_ATOL:g} m/s)")
        out["cpu"] = gap
        del _capp, crec
        # 3. save back as .unv and reload it
        app.save_path = os.path.join(tmp, "edited.unv")
        t0 = time.perf_counter()
        app.handle_key(0, "s")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = editor_app.open_world(app.save_path, dev, settings_path=os.path.join(tmp, "r.ini"),
                                      data_dirs=(tmp,))
        reload_s = time.perf_counter() - t0
        exports = []
        for inst in (app.scene_inst, again.scene_inst):
            sc = inst_mod.export_scene(inst)
            sc.pop("_export_new_entities")
            sc.pop("_export_new_components")
            exports.append(sc)
        diff = H.scene_diff(exports[1], exports[0])
        counts = (world.entity_count, again.world.entity_count)
        names = sorted(world.names.values()) == sorted(again.world.names.values())
        # the bodies come to rest (the Runner's ticks, no present), for K2's operands
        r = app.scene_view().runner()
        _zero_launches()
        for _ in range(EDITOR_LAND_FRAMES):
            r.tick()
        torch.cuda.synchronize()
        land = _launches()
        launches = {k: v + land[k] for k, v in launches.items()}
        log(f"[14 editor] {card}: EditorApp on stress.unv ({EDITOR_ENTITIES} entities, "
            f"{EDITOR_BODIES} bodies) on {app.device}: opened in {times['open_s']:.3f} s; the key "
            f"script in {script_s:.2f} s (host clock, a sync after each key): render_text "
            f"{med(times['render_text'])} ms; scene view frame() at "
            f"{EDITOR_SCENE_TEXT[0]}x{2 * (EDITOR_SCENE_TEXT[1] - 2)} {med(times['scene_frame'])} "
            f"ms; a command {med(times['command'])} ms, an undo {med(times['undo'])} ms, a redo "
            f"{med(times['redo'])} ms; saved as .unv in {save_s:.3f} s "
            f"({os.path.getsize(app.save_path)} bytes), reloaded in {reload_s:.3f} s: export "
            f"against the edited world's, first difference {diff}, entities {counts[0]} and "
            f"{counts[1]}, names equal {names}; then {EDITOR_LAND_FRAMES} Runner ticks; launches over the phase "
            f"{launches}; finite {finite}; status '{app.status}'")
        if diff is not None or counts[0] != counts[1] or not names or not finite or not (launches["K1"] > 0
                                                              and launches["K2"] > 0):
            raise AssertionError(f"editor tier: export diff {diff}, entities {counts}, finite "
                                 f"{finite}, launches {launches}")
        out.update(launches=launches, save_s=save_s, reload_s=reload_s, times=times,
                   script_s=script_s)
        del again
        # 4. K1 and K2 on the path's own operands
        st = r.state
        out["k1"] = k1_on_state("14 editor tier", world, st)
        out["k2"] = k2_on_state(pm, map_tensors(lambda t: t[None], st), "the editor tier")
        log(f"[14 K2] {card}: on the path's contact set W={out['k2']['W']} NB={out['k2']['NB']} "
            f"C={out['k2']['C']} active {out['k2']['active']}: max abs err vs plain "
            f"{out['k2']['max_abs_err']:.3e}, {out['k2']['ms']:.4f} ms (plain "
            f"{out['k2']['plain_ms']:.4f} ms, bound {out['k2']['bound_ms']:.6f} ms over "
            f"{out['k2']['bytes']} bytes, share {out['k2']['share_of_bound']:.4f})")
        del app, r
        # 5. the sharded step's dry run on the card
        torch.cuda.synchronize()
        _zero_launches()
        dry = {}
        t0 = time.perf_counter()
        rc = dryrun.main(EDITOR_DRYRUN_SHARDS, dev, out=dry)
        torch.cuda.synchronize()
        dry.update(s=time.perf_counter() - t0, launches=_launches())
        log(f"[14 dryrun] {card}: parallel/dryrun.py with {EDITOR_DRYRUN_SHARDS} shards over "
            f"{dry['devices']} ({torch.cuda.device_count()} card(s): "
            f"{'the card repeated' if torch.cuda.device_count() < EDITOR_DRYRUN_SHARDS else 'a card each'}"
            f") in {dry['s']:.2f} s: rc {rc}, visible_total {dry['visible_total']} equal to the "
            f"unsharded step's, position gap {dry['pos_gap']:.3e} (limit "
            f"{dryrun.CARD_POS_ATOL:g}); launches {dry['launches']}")
        if rc != 0:
            raise AssertionError(f"dry run rc {rc}")
        out["dryrun"] = dry
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _body_gap(a, b):
    """The largest gap between two physics states' body fields."""
    return max(float((getattr(a, f) - getattr(b, f)).abs().max())
               for f in ("pos", "rot", "vel", "angvel"))


def _entity_order(t, slot_of):
    """A slot-ordered Transform [..., c, N] in entity order."""
    from lumixengine_tpu_torch.core.transform import Transform

    return Transform(pos=t.pos.index_select(-1, slot_of), rot=t.rot.index_select(-1, slot_of),
                     scale=t.scale.index_select(-1, slot_of))


def _transform_gap(a, b):
    return max(float((getattr(a, f) - getattr(b, f)).abs().max()) for f in ("pos", "rot", "scale"))


def surface_backends(dev, world, engine, start):
    """Phase 15's first part: SURFACE_FRAMES frames of the flagship from
    `start` under each solver_backend, the launch counts set to 0 just
    before each run and read just after; CUDA events over the frames after
    the first. Returns {backend: {"first", "end", "ms", "launches"}}."""
    import torch

    rm, pm = world.modules["renderer"], world.modules["physics"]
    step = engine.build_step(world, dev, extra=rm.cull_pass)
    runs = {}
    try:
        for backend in SURFACE_BACKENDS:
            pm.solver_backend = backend
            torch.cuda.synchronize()
            _zero_launches()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            first = step(start, DT)
            ev0.record()
            state = first
            for _ in range(SURFACE_FRAMES - 1):
                state = step(state, DT)
            ev1.record()
            torch.cuda.synchronize()
            runs[backend] = {"first": first.modules["physics"], "end": state,
                             "ms": ev0.elapsed_time(ev1) / (SURFACE_FRAMES - 1),
                             "launches": _launches()}
    finally:
        pm.solver_backend = "auto"
    return runs, step


def run_surface_tier(dev, card):
    """Phase 15: the JAX package's last public surface on the card.

    1. The flagship (full_frame_world(N_ENTITIES, N_CHARACTERS, N_BODIES,
       N_PARTICLES), the pruned branch) at WORLDS worlds with its bodies
       piled (demo_scenes.pile_bodies), SURFACE_FRAMES frames under each
       solver_backend: ms a frame, K2's launches (one a frame under auto
       and pallas, none under jnp), the jnp state's largest body gap to
       auto's after the first frame (held to SURFACE_JNP_ATOL) and after
       the last (printed); K2 against its plain version on the end state's
       contact set.
    2. The slot step's classic tier (SURFACE_SLOT_TIERS) on the 10k-box
       drop from its step-1200 state, SURFACE_BOX_STEPS steps each: ms a
       step, the certificates, every body finite and above the ground.
    3. propagate, propagate_indexed and, where hierarchy_is_uniform_scale
       holds, propagate_doubling on the flagship batch's locals in entity
       order against propagate_plan's globals: the gap and ms a call.
    4. culling_system.cull on the renderer's culled entities at WORLDS
       worlds under the world camera and a random view per world, the
       launch counts set to 0 just before and read just after; K1 held bit
       for bit to its plain version on the same operands.
    5. blend_palette and skin_points on the ybot-size character
       (models/asset_scenes.character_fbx through importers/fbx.to_model)
       over SURFACE_ANIMATORS animators of random rigid bone transforms,
       against gpu_soft.skin_points_dq_np on the host.
    6. One flagship step with the floating-point traps on (it passes), then
       one from a state with a NaN in a body's velocity: it must raise
       FloatingPointError naming modules.physics.vel; any other exception
       fails the phase.
    Returns the launch counts over the parts that drive the path (1, 4 and
    6), K1's check and K2's record."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.core import debug
    from lumixengine_tpu_torch.core import host_math as hm
    from lumixengine_tpu_torch.importers import fbx
    from lumixengine_tpu_torch.models import asset_scenes as A
    from lumixengine_tpu_torch.models.demo_scenes import (box_drop_pile, full_frame_world,
                                                          pile_bodies)
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import hierarchy as hier
    from lumixengine_tpu_torch.ops import skinning
    from lumixengine_tpu_torch.parallel.mesh import replicate_state
    from lumixengine_tpu_torch.renderer import culling_system, pipeline
    from lumixengine_tpu_torch.renderer.gpu_soft import skin_points_dq_np

    dev = torch.device(dev)
    launches = {"K1": 0, "K2": 0, "TF": 0}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    out = {}
    # 1. solver_backend
    engine, world, *_ = full_frame_world(N_ENTITIES, N_CHARACTERS, N_BODIES, N_PARTICLES)
    rm, pm = world.modules["renderer"], world.modules["physics"]
    if not pm.statics().pruned:
        raise AssertionError("the flagship's physics is not on the pruned branch")
    start = pile_bodies(replicate_state(world.device_state(dev), WORLDS,
                                        torch.Generator(device=dev).manual_seed(15)))
    runs, step = surface_backends(dev, world, engine, start)
    for r in runs.values():
        count(r["launches"])
    gap1 = _body_gap(runs["jnp"]["first"], runs["auto"]["first"])
    gap_end = _body_gap(runs["jnp"]["end"].modules["physics"], runs["auto"]["end"].modules["physics"])
    gap_pallas = {b: _body_gap(r["end"].modules["physics"], runs["auto"]["end"].modules["physics"])
                  for b, r in runs.items() if b == "pallas"}
    active = int(runs["auto"]["first"].counters["active_contacts"].sum())
    finite = all(bool(torch.isfinite(t).all()) for r in runs.values()
                 for t in _float_tensors(r["end"].modules["physics"]))
    k2_counts = {b: r["launches"]["K2"] for b, r in runs.items()}
    log(f"[15 backends] {card}: the flagship at W={WORLDS}, bodies piled, {SURFACE_FRAMES} frames "
        f"each: " + "; ".join(f"{b} {r['ms']:.3f} ms/frame (K1 {r['launches']['K1']}, K2 "
                              f"{r['launches']['K2']} launches)" for b, r in runs.items())
        + f"; active contacts in frame 1 {active}; jnp vs auto body gap after frame 1 {gap1:.3e} "
        f"(limit {SURFACE_JNP_ATOL:g}), after frame {SURFACE_FRAMES} {gap_end:.3e} (no bound); "
        f"pallas vs auto after frame {SURFACE_FRAMES} {gap_pallas}; finite {finite}")
    expected = {b: 0 if b == "jnp" else SURFACE_FRAMES for b in SURFACE_BACKENDS}
    if k2_counts != expected or not gap1 <= SURFACE_JNP_ATOL or not finite or active == 0:
        raise AssertionError(f"solver_backend: K2 launches {k2_counts} (expected {expected}), jnp "
                             f"gap {gap1}, finite {finite}, active {active}")
    out["backends"] = {b: {"ms": r["ms"], "launches": r["launches"]} for b, r in runs.items()}
    out["k2_backends"] = k2_counts
    out["jnp_gap"] = {"frame 1": gap1, f"frame {SURFACE_FRAMES}": gap_end}
    out["k2"] = k2_on_state(pm, runs["auto"]["end"], "the surface tier")
    log(f"[15 K2] {card}: on the phase's contact set W={out['k2']['W']} NB={out['k2']['NB']} "
        f"C={out['k2']['C']} active {out['k2']['active']}: max abs err vs plain "
        f"{out['k2']['max_abs_err']:.3e} (limit 1e-4), {out['k2']['ms']:.4f} ms (plain "
        f"{out['k2']['plain_ms']:.4f} ms, bound {out['k2']['bound_ms']:.4f} ms, share "
        f"{out['k2']['share_of_bound']:.4f})")
    del runs

    # 3. the other propagations, in entity order
    plan = world.plan
    local = start.local
    ref = hier.propagate_plan(local, plan)
    slot_of = torch.as_tensor(world.to_slots(np.arange(world.capacity)).astype(np.int64),
                              device=dev)
    local_e, ref_e = _entity_order(local, slot_of), _entity_order(ref, slot_of)
    parent = torch.as_tensor(world.parent.astype(np.int64), device=dev)
    level_np, _idx = hier.compute_level_indices_host(world.parent)
    level = torch.as_tensor(level_np, device=dev)
    depth, uniform = world.max_depth, world.hierarchy_is_uniform_scale()
    reach = 2 ** max(1, int(np.ceil(np.log2(max(depth, 1))))) - 1
    fns = {"propagate": lambda: hier.propagate(local_e, parent, level, depth),
           "propagate_indexed": lambda: hier.propagate_indexed(local_e, parent,
                                                               world.level_indices)}
    if uniform:
        fns["propagate_doubling"] = lambda: hier.propagate_doubling(local_e, parent, depth)
    props = {"propagate_plan": {"ms": cuda_time(lambda: hier.propagate_plan(local, plan), 5)}}
    for name, fn in fns.items():
        props[name] = {"gap": _transform_gap(fn(), ref_e), "ms": cuda_time(fn, 5)}
    log(f"[15 hierarchy] {card}: the flagship's hierarchy at {list(local.pos.shape)} (max depth "
        f"{depth}, {sum(len(i) for i in world.level_indices)} entities under a parent; uniform "
        f"scale {uniform}, so propagate_doubling "
        f"{'runs' if uniform else 'is not exact here and is not run'}; its rounds reach "
        f"{reach} levels), in entity order against propagate_plan (limits {TRANSFORM_ATOL:g}, "
        f"doubling {SURFACE_DOUBLING_ATOL:g}): "
        + "; ".join(f"{n} gap {r['gap']:.3e}, {r['ms']:.4f} ms a call" if "gap" in r
                    else f"{n} {r['ms']:.4f} ms a call" for n, r in props.items()))
    limit = {"propagate": TRANSFORM_ATOL, "propagate_indexed": TRANSFORM_ATOL,
             "propagate_doubling": SURFACE_DOUBLING_ATOL if reach >= depth else float("inf")}
    bad = {n: r["gap"] for n, r in props.items() if "gap" in r and not r["gap"] <= limit[n]}
    if bad:
        raise AssertionError(f"propagations off propagate_plan beyond {limit}: {bad}")
    out["hierarchy"] = props

    # 4. culling_system.cull on the culled entities
    rs = start.modules["renderer"]
    cs = rs.culling
    frustum, _c, _r = pipeline.cull_operands(start.replace(world=ref), rs, rm.statics())
    plane_sets = {"world camera": frustum.planes.contiguous(),
                  "random views": random_planes(WORLDS, dev)}
    torch.cuda.synchronize()
    _zero_launches()
    vis = {k: culling_system.cull(cs, ref.pos, ref.scale, p) for k, p in plane_sets.items()}
    torch.cuda.synchronize()
    cull_launches = _launches()
    count(cull_launches)
    eidx = cs.entity.clamp_min(0).to(torch.int64)
    lanes = eidx.unsqueeze(-2).expand(eidx.shape[:-1] + (3, eidx.shape[-1]))
    centers = torch.gather(ref.pos, -1, lanes).contiguous()
    radii = (cs.radius * torch.gather(ref.scale, -1, lanes).abs().amax(dim=-2)).contiguous()
    live = cs.entity >= 0
    mism, err, fracs = 0, 0.0, []
    for k, p in plane_sets.items():
        plain = cull.frustum_cull_plain(centers, radii, p) & live
        mism += int((vis[k] != plain).sum())
        err = max(err, max_err([vis[k].float()], [plain.float()]))
        fracs.append(float(vis[k].float().mean()))
    cam = plane_sets["world camera"]
    cull_ms, plain_ms = alternate(
        lambda: cull.frustum_cull_plain(centers, radii, cam) & live,
        lambda: culling_system.cull(cs, ref.pos, ref.scale, cam), 5, 20)
    per_world = int(live.reshape(-1, live.shape[-1])[0].sum())
    log(f"[15 cull] {card}: culling_system.cull on {per_world} culled entities a world ({cs.entity.shape[-1]} store slots) at W={WORLDS}, world camera "
        f"and random views {list(centers.shape)}: "
        f"{mism} mismatches with K1's plain version on the same operands (visible fractions "
        f"{[round(f, 4) for f in fracs]}); K1 launches {cull_launches['K1']} for 2 calls; "
        f"{cull_ms:.4f} ms a call (the plain version's {plain_ms:.4f} ms)")
    if mism or cull_launches["K1"] != len(plane_sets) or not 0.0 < fracs[0] < 1.0:
        raise AssertionError(f"cull: {mism} mismatches, launches {cull_launches}, fractions "
                             f"{fracs}")
    out["k1"] = {"mismatches": mism, "max_abs_err": err, "shape": list(centers.shape)}
    out["cull"] = {"ms": cull_ms, "plain_ms": plain_ms}

    # 6. the floating-point traps
    debug.enable_floating_point_traps(True)
    try:
        torch.cuda.synchronize()
        _zero_launches()
        clean = step(start, DT)
        ph = clean.modules["physics"]
        vel = ph.vel.clone()
        vel[0, 0, 0] = float("nan")
        planted = clean.replace(modules={**clean.modules, "physics": ph.replace(vel=vel)})
        try:
            step(planted, DT)
        except FloatingPointError as e:
            message = str(e)
        else:
            raise AssertionError("a step on a NaN velocity did not raise with the traps on")
        torch.cuda.synchronize()
        trap_launches = _launches()
        count(trap_launches)
    finally:
        debug.enable_floating_point_traps(False)
    log(f"[15 traps] {card}: a flagship step at W={WORLDS} with the traps on passed; a step from "
        f"a NaN in body 0's velocity raised FloatingPointError: '{message[:160]}'; launches "
        f"{trap_launches}")
    if "modules.physics.vel" not in message:
        raise AssertionError(f"the trap did not name the field: {message}")
    del start, ref, local, local_e, ref_e, clean, planted, vis

    # 2. the classic slot tier
    z = np.load(os.path.join(GOLDEN_DIR, "boxes_step1200.npz"))
    boxes = {}
    for name, tier in SURFACE_SLOT_TIERS.items():
        bstep, _init, consts = box_drop_pile(N_BOXES, device=dev, **tier)
        body = [torch.as_tensor(z[k], device=dev) for k in ("pos", "rot", "vel", "angvel")]
        carry = tuple(torch.as_tensor(z[f"carry{i}"], device=dev) for i in range(6))
        dt = torch.tensor(DT, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        drop, miss = zero, zero
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(SURFACE_BOX_STEPS):
            *body, ctr, carry = bstep(*body, dt, carry, consts)
            drop = drop + ctr["slot_drop"]
            miss = miss + ctr["column_miss"]
        ev1.record()
        torch.cuda.synchronize()
        pos = body[0]
        r = {"ms": ev0.elapsed_time(ev1) / SURFACE_BOX_STEPS, "slot_drop": int(drop),
             "column_miss": int(miss), "active_contacts": int(ctr["active_contacts"]),
             "max_candidates": int(ctr["max_candidates"]), "sleeping": int(ctr["sleeping"]),
             "lowest": float(pos[1].min()), "below": int((pos[1] < BOX_Y_MIN).sum()),
             "finite": all(bool(torch.isfinite(t).all()) for t in body)}
        boxes[name] = r
        if not r["finite"] or not r["lowest"] > 0.0:
            raise AssertionError(f"classic tier {name}: finite {r['finite']}, lowest centre "
                                 f"{r['lowest']} m")
    log(f"[15 slots] {card}: the slot step's classic tier, {N_BOXES} boxes from the drop's step "
        f"1200, {SURFACE_BOX_STEPS} steps each: " + "; ".join(
            f"{n} {r['ms']:.3f} ms/step, certificates slot_drop {r['slot_drop']} column_miss "
            f"{r['column_miss']}, active contacts {r['active_contacts']}, max candidates "
            f"{r['max_candidates']}, sleeping {r['sleeping']}, lowest centre {r['lowest']:.4f} m "
            f"({r['below']} below {BOX_Y_MIN} m)" for n, r in boxes.items())
        + "; every body finite and above the ground")
    out["slots"] = boxes

    # 5. skinning on the ybot-size character
    m = fbx.to_model(fbx.FbxDoc(fbx.parse_fbx(A.character_fbx())))
    pts = np.asarray(m.vertex_positions, np.float32)
    bones4, wts = np.asarray(m.vertex_bones4), np.asarray(m.vertex_weights, np.float32)
    nbones = m.skeleton.bone_count
    rng = np.random.default_rng(15)
    axis = rng.normal(size=(nbones, SURFACE_ANIMATORS, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = rng.uniform(0, 0.4, (nbones, SURFACE_ANIMATORS, 1))
    real = np.concatenate([axis * np.sin(half), np.cos(half)], -1)
    trans = rng.uniform(-0.2, 0.2, (nbones, SURFACE_ANIMATORS, 3))
    dual = 0.5 * hm.quat_mul(np.concatenate([trans, np.zeros_like(half)], -1), real)
    pal = np.moveaxis(np.concatenate([real, dual], -1), -1, 0).astype(np.float32)   # [8, B, A]
    wbv = skinning.weights_matrix(bones4, wts, nbones)
    pal_t, w_t = torch.as_tensor(pal, device=dev), torch.as_tensor(wbv, device=dev)
    rest = torch.as_tensor(np.ascontiguousarray(pts.T), device=dev)

    def skin():
        return skinning.skin_points(skinning.blend_palette(pal_t, w_t), rest)

    got = skin().permute(1, 0, 2).cpu().numpy()                      # [V, 3, A]
    host = np.stack([skin_points_dq_np(pal[:, :, a], pts, bones4, wts)
                     for a in range(SURFACE_ANIMATORS)], -1)
    skin_gap = float(np.abs(got - host).max())
    skin_ms = cuda_time(skin, 10)
    log(f"[15 skinning] {card}: blend_palette + skin_points on the character ({nbones} bones, "
        f"{len(pts)} points, extent {float(np.ptp(pts, axis=0).max()):.3f} m) over "
        f"{SURFACE_ANIMATORS} animators: {skin_ms:.4f} ms a call; against "
        f"gpu_soft.skin_points_dq_np on the host: max abs gap {skin_gap:.3e} m (limit "
        f"{SURFACE_SKIN_ATOL:g})")
    if not skin_gap <= SURFACE_SKIN_ATOL:
        raise AssertionError(f"skinning: {skin_gap} m from the host formula")
    out["skinning"] = {"ms": skin_ms, "gap": skin_gap, "bones": nbones, "points": len(pts)}
    out["launches"] = launches
    log(f"[15 launches] {card}: over the phase's path (the backends' frames, the culls, the trap "
        f"steps): {launches}")
    return out


def _cull_gaps(gpu, cpu):
    """Slots whose mi_lod, mi_visible or mi_model differ between the card's
    first worlds and the CPU's run of them."""
    rg, rc = gpu.modules["renderer"], cpu.modules["renderer"]
    n = rc.mi_lod.shape[0]
    return {f: int((getattr(rg, f)[:n].cpu() != getattr(rc, f)).sum())
            for f in ("mi_lod", "mi_visible", "mi_model")}


def _edit_frames(engine, world, state, cpu, frames, compare):
    """`frames` frames from an edit: the steps built anew for the card and
    the CPU, the launch counts set to 0 just before the card's frames and
    read just after, compare(card state, CPU state) after each frame.
    Returns (card state, CPU state, the comparisons, launches)."""
    import torch

    rm = world.modules["renderer"]
    step = engine.build_step(world, state.local.pos.device, extra=rm.cull_pass)
    cpu_step = engine.build_step(world, "cpu", extra=rm.cull_pass)
    seen = []
    torch.cuda.synchronize()
    _zero_launches()
    for _ in range(frames):
        state, cpu = step(state, DT), cpu_step(cpu, DT)
        seen.append(compare(state, cpu))
    torch.cuda.synchronize()
    return state, cpu, seen, _launches()


def run_members_tier(dev, card):
    """Phase 16: the JAX classes' last public members on the card, driven
    through the paths that launch K1 and K2.

    1. The demo (headless_demo_world(DEMO_ENTITIES)) at MEMBERS_DEMO_WORLDS
       worlds: one frame, then every model instance re-pointed to (old + 1)
       mod 4 through reflection.registry.set_property, then
       MEMBERS_EDIT_FRAMES frames on the card and, from the same state, on
       the CPU for MEMBERS_CPU_WORLDS worlds: mi_lod, mi_visible and
       mi_model equal in every slot; the view statics equal statics built
       anew; the edit moved LODs. Then RenderModule.set_model on one
       instance: its model, its cull radius in the store and the statics,
       one frame card against CPU.
    2. The flagship (its bodies piled, so that K2 has contacts) at WORLDS
       worlds with a second controller: one frame, then each animable's clip
       and time_scale and every other animator's controller set through
       the registry, one animator's speed through set_animator_input (the
       inputs taken from the module's defaults, as a state built anew
       carries them), MEMBERS_EDIT_FRAMES frames card against CPU: poses and
       palettes within POSE_ATOL, clocks within CLOCK_ATOL; the groups read
       the new time scales, and the first frame's clocks advanced by them.
    3. The palette's cost at WORLDS worlds: ms a frame with build_palettes
       on and off (MEMBERS_PALETTE_FRAMES frames a run after
       MEMBERS_PALETTE_WARM, runs on, off, off, on; the median and the
       spread of CUDA events a frame); with it off the palette is untouched.
    4. K1 on the demo's and the flagship's end states bit for bit, K2 on the
       flagship's contact set within K2_PLAIN_ATOL, against their plain
       versions.
    Returns the launches over the parts that drive the path (1-3), K1's and
    K2's records and the palette's timing. No part falls back: any failure
    raises."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.animation.controller import (AnimationNode, Blend1D, Controller,
                                                            Input)
    from lumixengine_tpu_torch.engine import reflection
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models.demo_scenes import (full_frame_world, headless_demo_world,
                                                          pile_bodies)
    from lumixengine_tpu_torch.parallel.mesh import replicate_state
    from lumixengine_tpu_torch.renderer.pipeline import ViewStatics

    dev = torch.device(dev)
    reflection.register_builtin_components()
    reg = reflection.registry
    launches = {"K1": 0, "K2": 0, "TF": 0}

    def count(got):
        for k in launches:
            launches[k] += got[k]

    def first(state):
        return map_tensors(lambda t: t[:MEMBERS_CPU_WORLDS].to("cpu"), state)

    def one_frame(engine, world, state):
        torch.cuda.synchronize()
        _zero_launches()
        state = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)(state, DT)
        torch.cuda.synchronize()
        count(_launches())
        return state

    out = {"k1": {}}
    # 1. the demo: the model instances re-pointed through the registry, then set_model
    engine, world, rsys = headless_demo_world(DEMO_ENTITIES)
    rm = world.modules["renderer"]
    store = rm.model_instances
    state = one_frame(engine, world, replicate_state(
        world.device_state(dev), MEMBERS_DEMO_WORLDS, torch.Generator(device=dev).manual_seed(16)))
    before = state.modules["renderer"].mi_lod.clone()
    ents = [int(e) for e in store.entity[store.mask()]]
    for e in ents:
        reg.set_property(world, e, "model_instance", "model", (int(store.get(e, "model")) + 1) % 4)
    dropped = rm._statics is None
    state, _cpu, gaps, got = _edit_frames(engine, world, state, first(state),
                                          MEMBERS_EDIT_FRAMES, _cull_gaps)
    count(got)
    moved = int((state.modules["renderer"].mi_lod != before).sum())
    # the view statics and their tensors on the card equal statics built anew from the stores
    st, built = rm.statics(), ViewStatics(rm)
    fresh = all(np.array_equal(getattr(st, f), getattr(built, f))
                and np.array_equal(getattr(st.on(dev), f).cpu().numpy(), getattr(built, f))
                for f in ("lod_dist2", "material", "mi_model", "radius"))
    log(f"[16 demo] {card}: headless_demo_world({DEMO_ENTITIES}) at W={MEMBERS_DEMO_WORLDS}, "
        f"{len(ents)} model instances re-pointed through the registry after frame 1 (statics "
        f"dropped by the setter {dropped}); {MEMBERS_EDIT_FRAMES} frames, launches {got}; card vs "
        f"CPU on {MEMBERS_CPU_WORLDS} worlds, slots that differ per frame: {gaps}; mi_lod changed "
        f"by the edit in {moved} of {before.numel()} slots; view statics equal statics built anew "
        f"{fresh}")
    if (not dropped or any(sum(g.values()) for g in gaps) or not fresh or moved == 0
            or not _launched(got, MEMBERS_EDIT_FRAMES, 0)):
        raise AssertionError(f"the demo's model edit: dropped {dropped}, gaps {gaps}, statics "
                             f"fresh {fresh}, moved {moved}, launches {got}")
    e = ents[0]
    name = next(n for n in ("tree", "rock", "cube") if rsys.models.get_id(n) != store.get(e, "model"))
    mid = rsys.models.get_id(name)
    radius = np.float32(rsys.models.get(mid).bounding_radius)
    rm.set_model(e, name)
    slot = store.slot_of(e)
    st = rm.statics()
    held = {"model": int(store.get(e, "model")) == mid,
            "store radius": bool(rm.culling.store.get(e, "radius") == radius),
            "statics radius": bool(st.radius[slot] == radius),
            "card radius": bool(float(st.on(dev).radius[slot]) == radius),
            "statics model": int(st.mi_model[slot]) == mid}
    state, _cpu, set_gaps, got = _edit_frames(engine, world, state, first(state), 1, _cull_gaps)
    count(got)
    log(f"[16 set_model] {card}: entity {e} to {name!r} (id {mid}, bounding radius {radius}): "
        f"{held}; one frame card vs CPU, slots that differ {set_gaps}; launches {got}")
    if not all(held.values()) or any(sum(g.values()) for g in set_gaps):
        raise AssertionError(f"set_model: {held}, gaps {set_gaps}")
    out["k1"]["demo"] = k1_on_path("members demo", world, state, phase="16")
    out["demo"] = {"gaps": gaps, "moved": moved, "set_model_gaps": set_gaps}
    del state, before

    # 2. the flagship: animables, animators and an input edited
    engine, world, *_r, anim, _p = full_frame_world(N_ENTITIES, N_CHARACTERS, N_BODIES,
                                                    N_PARTICLES)
    stride = anim.add_controller(Controller(
        "stride", anim.bank_statics,
        Blend1D(Input(0), [(0.0, AnimationNode(1)), (2.0, AnimationNode(2))]), inputs=["speed"]))
    am, pm = world.modules["animation"], world.modules["physics"]
    state = one_frame(engine, world, pile_bodies(replicate_state(
        world.device_state(dev), WORLDS, torch.Generator(device=dev).manual_seed(16))))
    animables = [int(x) for x in am.animables.entity[am.animables.mask()]]
    for i, x in enumerate(animables):
        reg.set_property(world, x, "animable", "clip", (int(am.animables.get(x, "clip")) + 1) % 3)
        reg.set_property(world, x, "animable", "time_scale", 0.5 + 0.25 * (i % 8))
    ators = [int(x) for x in am.animators.entity[am.animators.mask()]]
    for x in ators[::2]:
        reg.set_property(world, x, "animator", "controller", stride)
    am.set_animator_input(ators[1], "speed", 3.7)
    inputs = torch.as_tensor(am.default_inputs, device=dev)
    ms = state.modules["animation"]
    state = state.replace(modules={**state.modules, "animation": ms.replace(
        ctrl_inputs=inputs.expand(ms.ctrl_inputs.shape).clone())})
    clocks = [state.modules["animation"].an_time[:MEMBERS_CPU_WORLDS].cpu()]

    def anim_gap(gpu, cpu):
        ga, ca = gpu.modules["animation"], cpu.modules["animation"]
        clocks.append(ca.an_time)
        return {f: float((getattr(ga, f)[:MEMBERS_CPU_WORLDS].cpu() - getattr(ca, f)).abs().max())
                for f in ("an_time", "ctrl_clocks", "pose_pos", "pose_rot", "palette")}

    cpu = first(state)
    state, cpu, errs, got = _edit_frames(engine, world, state, cpu, MEMBERS_EDIT_FRAMES, anim_gap)
    count(got)
    st = am.statics()
    scales = {float(v) for g in st.an_groups for v in g["scale"]}
    reads = all(np.array_equal(g["scale"], am.animables.data["time_scale"][g["cols"]])
                and np.array_equal(gd.scale.cpu().numpy(), g["scale"])
                for g, gd in zip(st.an_groups, st.on(dev).an))
    # the first frame after the edit advanced each animable's clock by dt at its new scale
    col_scale, col_len = torch.zeros_like(clocks[0][0]), torch.ones_like(clocks[0][0])
    for g in st.an_groups:
        col_scale[g["cols"]] = torch.as_tensor(g["scale"])
        col_len[g["cols"]] = torch.as_tensor(g["lengths"])
    used = torch.as_tensor(am.animables.entity >= 0)
    expect = torch.remainder(clocks[0] + torch.tensor(DT) * col_scale, col_len)
    advance = float((clocks[1] - expect)[..., used].abs().max())
    controllers = sorted({g["controller"].name for g in st.at_groups})
    worst = {f: max(e[f] for e in errs) for f in errs[0]}
    log(f"[16 anim] {card}: the flagship at W={WORLDS}, bodies piled; after frame 1, "
        f"{len(animables)} animables' clip and time_scale and {len(ators[::2])} of {len(ators)} "
        f"animators' controller set through the registry, entity {ators[1]}'s speed through "
        f"set_animator_input (default {float(am.default_inputs[0, am.animators.slot_of(ators[1])])});"
        f" {MEMBERS_EDIT_FRAMES} frames, launches {got}; card vs CPU on {MEMBERS_CPU_WORLDS} worlds,"
        f" max abs err {worst} (poses and palettes limit {POSE_ATOL:g}, clocks {CLOCK_ATOL:g}); "
        f"groups read the new time scales {reads} ({sorted(scales)}), the first frame's clocks "
        f"{advance:.3e} from dt at them, controllers {controllers}")
    if (not reads or not advance <= 1e-6 or worst["pose_pos"] > POSE_ATOL or worst["pose_rot"] > POSE_ATOL
            or worst["palette"] > POSE_ATOL or worst["an_time"] > CLOCK_ATOL
            or worst["ctrl_clocks"] > CLOCK_ATOL or controllers != ["locomotion", "stride"]
            or scales != {0.5 + 0.25 * i for i in range(min(8, len(animables)))}
            or not _launched(got, MEMBERS_EDIT_FRAMES, MEMBERS_EDIT_FRAMES)):
        raise AssertionError(f"the flagship's animation edits: {worst}, reads {reads}, "
                             f"controllers {controllers}, scales {scales}, launches {got}")
    del cpu, clocks

    # 3. the palette's cost
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    runs = {True: [], False: []}
    untouched = True
    torch.cuda.synchronize()
    _zero_launches()
    for on in (True, False, False, True):
        am.build_palettes = on
        pal = state.modules["animation"].palette.clone()
        for f in range(MEMBERS_PALETTE_WARM + MEMBERS_PALETTE_FRAMES):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            state = step(state, DT)
            ev1.record()
            if f >= MEMBERS_PALETTE_WARM:
                runs[on].append((ev0, ev1))
        torch.cuda.synchronize()
        if not on:
            untouched &= bool(torch.equal(state.modules["animation"].palette, pal))
    am.build_palettes = True
    got = _launches()
    count(got)
    frames = 4 * (MEMBERS_PALETTE_WARM + MEMBERS_PALETTE_FRAMES)
    timing = {}
    for on, evs in runs.items():
        ms = sorted(a.elapsed_time(b) for a, b in evs)
        timing["on" if on else "off"] = {"median_ms": float(np.median(ms)),
                                         "spread_ms": ms[-1] - ms[0], "frames": len(ms)}
    cost = timing["on"]["median_ms"] - timing["off"]["median_ms"]
    log(f"[16 palettes] {card}: the flagship at W={WORLDS}, ms a frame (median of "
        f"{2 * MEMBERS_PALETTE_FRAMES} CUDA-event frames in runs on, off, off, on; spread max - "
        f"min): build_palettes on {timing['on']['median_ms']:.3f} (spread "
        f"{timing['on']['spread_ms']:.3f}), off {timing['off']['median_ms']:.3f} (spread "
        f"{timing['off']['spread_ms']:.3f}); the palette's cost {cost:.3f} ms a frame; palette "
        f"untouched with it off {untouched}; launches {got} over {frames} frames")
    if not untouched or not _launched(got, frames, frames):
        raise AssertionError(f"build_palettes: untouched {untouched}, launches {got}")
    out["palettes"] = {**timing, "cost_ms": cost}

    # 4. the kernels on the phase's own operands
    out["k1"]["flagship"] = k1_on_path("members flagship", world, state, phase="16")
    out["k2"] = k2_on_state(pm, state, "the members tier")
    log(f"[16 K2] {card}: on the phase's contact set W={out['k2']['W']} NB={out['k2']['NB']} "
        f"C={out['k2']['C']} active {out['k2']['active']}: max abs err vs plain "
        f"{out['k2']['max_abs_err']:.3e} (limit 1e-4), {out['k2']['ms']:.4f} ms (plain "
        f"{out['k2']['plain_ms']:.4f} ms, bound {out['k2']['bound_ms']:.4f} ms, share "
        f"{out['k2']['share_of_bound']:.4f})")
    out["launches"] = launches
    log(f"[16 launches] {card}: over the phase's path (the demo's edit and set_model frames, the "
        f"flagship's edit and palette frames): {launches}")
    return out


def k1_on_state(label, world, state):
    """K1 against its plain version on a one-world state's cull operands
    (the world camera and a random view), as the Runner's paths give them.
    Raises on a mismatch."""
    from lumixengine_tpu_torch.renderer import pipeline

    rm = world.modules["renderer"]
    frustum, centers, radii = pipeline.cull_operands(state, state.modules["renderer"], rm.statics())
    centers, radii = centers[None].contiguous(), radii[None].contiguous()
    bad, err, fracs = k1_check(centers, radii, (frustum.planes[None].contiguous(),
                                                random_planes(1, centers.device)))
    log(f"[{label}] K1 on the path's own operands {list(centers.shape)}: {bad} mismatches with "
        f"the plain version (visible fractions {[round(f, 4) for f in fracs]})")
    if bad:
        raise AssertionError(f"K1 is not bit-exact on the {label} path: {bad} mismatches")
    return {"mismatches": bad, "max_abs_err": err, "shape": list(centers.shape)}


def _timed_frames(step, state, frames, warm):
    """`frames` frames of `step` from `state`, the launch counts set to 0
    just before and read just after; CUDA events around the frames after
    `warm`. Returns (state, ms a frame, wall seconds, launches)."""
    import torch

    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _zero_launches()
    t0 = time.perf_counter()
    for f in range(frames):
        if f == warm:
            ev0.record()
        state = step(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, ev0.elapsed_time(ev1) / (frames - warm), wall, _launches()


def device_busy(step, state, layers, label="9 device"):
    """One frame of `step` on `state` and each of `layers` (name -> fn(dt)):
    ms on CUDA events beside the device time of their kernels
    (torch.profiler, layer_time); the frame's busy share is the second over
    the first. Printed under `label`; returns {name: (ms, device ms)}."""
    import torch

    dt = torch.tensor(DT, dtype=torch.float32, device=state.local.pos.device)
    out = {"frame": layer_time(lambda: step(state, DT), 10)}
    out.update({name: layer_time(lambda f=fn: f(dt)) for name, fn in layers.items()})
    frame_ms, frame_dev = out["frame"]
    share = f"{frame_dev / frame_ms:.4f}" if frame_dev else "not measured"
    log(f"[{label}] " + "; ".join(f"{k} {ms:.4f} ms on events, {dv if dv is None else round(dv, 4)}"
                                  f" ms of kernels" for k, (ms, dv) in out.items())
        + f"; the frame's device-busy share {share}")
    return out


def run_scripts_config(dev, replicate_state, map_tensors):
    """Phase 9a, bench.py --config scripts: script_stress_world(64) started,
    every mover compiled to the device fast path (7 groups, one a speed),
    build_step with the cull pass at SCRIPT_WORLDS worlds (72 entity slots a
    world), WARM_FRAMES + FRAMES frames timed, K1 held bit for bit to its
    plain version on the path's cull operands, 3 frames card vs CPU at W=4
    (the fast path's rows within SCRIPT_ATOL)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import script_stress_world

    engine, world, rm = script_stress_world(SCRIPT_MOVERS, device=dev)
    engine.start_game(world)
    sm = world.modules["script"]
    sm.prepare_statics(dev)
    n_fast = sum(len(g.entities) for g in sm._fast_groups)
    log(f"[9 scripts] {n_fast} of {SCRIPT_MOVERS} movers compiled to the device fast path in "
        f"{len(sm._fast_groups)} groups")
    if n_fast != SCRIPT_MOVERS:
        raise AssertionError(f"scripts config: {n_fast} of {SCRIPT_MOVERS} movers compiled")
    step = engine.build_step(world, dev, extra=rm.cull_pass)
    state = replicate_state(world.device_state(dev), SCRIPT_WORLDS,
                            torch.Generator(device=dev).manual_seed(0))
    rows = state.modules["script"]["fast"]
    where = sorted({t.device.type for t in rows.values()})
    log(f"[9 scripts] fast-path rows on {where}: {[tuple(t.shape) for t in rows.values()]}")
    if where != [torch.device(dev).type]:      # "cuda" when run as the script runs
        raise AssertionError(f"the fast path's rows are on {where}, not on {dev}")
    start = state.local.pos.clone()
    state, ms, wall, launches = _timed_frames(step, state, WARM_FRAMES + FRAMES, WARM_FRAMES)
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    slots = torch.as_tensor(world.to_slots(np.concatenate([g.entities for g in sm._fast_groups])),
                            device=dev).long()
    moved = (state.local.pos - start).index_select(-1, slots).norm(dim=-2)
    visible = state.modules["renderer"].counters["visible_count"]
    rate = SCRIPT_WORLDS * SCRIPT_MOVERS / (ms / 1e3)
    log(f"[9 scripts] W={SCRIPT_WORLDS}: {WARM_FRAMES + FRAMES} frames in {wall:.2f} s, launches "
        f"{launches}, finite {finite}, movers moved min/max {float(moved.min()):.3f}/"
        f"{float(moved.max()):.3f} m, visible min/max {int(visible.min())}/{int(visible.max())}")
    # the physics module runs its phases at zero bodies too: K2 once a
    # frame on an empty contact set, as the full engine's step does everywhere
    if not _launched(launches, WARM_FRAMES + FRAMES, WARM_FRAMES + FRAMES) or not finite:
        raise AssertionError(f"scripts config: launches {launches}, finite {finite}")
    if not float(moved.min()) > 0.0:
        raise AssertionError("a scripted mover did not move")
    k1 = k1_on_path("scripts", world, state)
    pm = world.modules["physics"]
    busy = device_busy(step, state, {"script.update": lambda d: sm.update(state, d),
                                     "physics.update_parallel (no bodies)":
                                     lambda d: pm.update_parallel(state, d)})
    k2 = k2_on_state(pm, state, "the scripts config")
    log(f"[9 scripts] K2 on the path's own (empty) contact set W={k2['W']} NB={k2['NB']} "
        f"C={k2['C']} active {k2['active']}: max abs err vs plain {k2['max_abs_err']:.3e}, "
        f"{k2['ms']:.4f} ms (plain {k2['plain_ms']:.4f} ms)")
    ops = op_counts(world, state, dev)
    log(f"[9 scripts] {ms:.3f} ms/frame at W={SCRIPT_WORLDS} = {rate:.4g} entity-steps/s "
        f"(bench.py's count: worlds x {SCRIPT_MOVERS} movers); torch ops in one frame "
        f"{sum(ops.values())} = {ops}")
    cmp = compare_with_plain(engine, world, map_tensors(lambda t: t[:4].clone(), state), step,
                             extra=(("modules.script.", SCRIPT_ATOL),))
    log(f"[9 scripts] 3 frames at W=4, card vs plain on the CPU: max abs err {cmp['errs']}, "
        f"boundary flips {cmp['flips']}")
    return {"ms": ms, "rate": rate, "ops": sum(ops.values()), "launches": launches, "k1": k1,
            "k2": k2, "cmp": cmp["errs"], "busy": busy}


def run_game_world(dev):
    """Phase 9b: the game world (models/game_scenes.py, built by
    create_full_engine) through Runner.tick at W=1 for the head-on streams'
    520 frames, a button press at frame 100: the JAX tests' gates
    (game_scenes.check_game)."""
    from lumixengine_tpu_torch import app
    from lumixengine_tpu_torch.models import game_scenes as G

    engine, world, h = G.game_world(dev)
    runner = app.Runner([], engine=engine)
    runner.use_world(world)
    _zero_launches()
    t0 = time.perf_counter()
    gaps, xs, clicks = G.run_game(runner, h)
    wall = time.perf_counter() - t0
    launches = _launches()
    sm = world.modules["script"]
    groups = [len(g.entities) for g in sm._fast_groups]
    out = G.check_game(runner, h, gaps, xs, clicks)
    log(f"[9 game] Runner.tick at W=1 on {runner.device}: {G.STREAM_FRAMES} frames in {wall:.2f} s"
        f" ({wall / G.STREAM_FRAMES * 1e3:.3f} ms a tick on the host's clock, logging reads "
        f"included), launches {launches}, compiled script groups {groups}; gates: {out}")
    if not _launched(launches, G.STREAM_FRAMES, G.STREAM_FRAMES) or groups != [1]:
        raise AssertionError(f"game world: launches {launches}, compiled groups {groups}")
    return {"ms_tick": wall / G.STREAM_FRAMES * 1e3, "launches": launches, "gates": out}


def run_nav_width(dev, replicate_state, map_tensors):
    """Phase 9c: the game world's device modules with the agent store at
    2 x NAV_CROSSING agents in two crossing streams (above the dense
    threshold: the x-sorted window regime), each world's agents nudged by
    N(0, 0.01^2) so that the worlds diverge, build_step with the cull pass
    at NAV_WORLDS worlds, WARM_FRAMES + FRAMES frames timed, then 3 frames
    card vs CPU at W=4 (navigation fields within NAV_ATOL, GUI and audio
    fields within TRANSFORM_ATOL, the rest equal)."""
    import torch

    from lumixengine_tpu_torch.models import game_scenes as G

    engine, world, h = G.game_world(dev, crossing=NAV_CROSSING)
    nav = world.modules["navigation"]
    engine.start_game(world)
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    t0 = time.perf_counter()
    single = G.start_navigation(world.device_state(dev), world, h)
    paths = time.perf_counter() - t0
    state = replicate_state(single, NAV_WORLDS, torch.Generator(device=dev).manual_seed(0))
    ns = state.modules["navigation"]
    g = torch.Generator(device=dev).manual_seed(1)
    nudge = torch.randn(ns.agent_pos.shape, generator=g, device=dev) * 0.01
    nudge[:, 1] = 0.0
    state = state.replace(modules={**state.modules, "navigation": ns.replace(
        agent_pos=ns.agent_pos + nudge)})
    gap0 = G.min_gap(state, world, h)
    state, ms, wall, launches = _timed_frames(step, state, WARM_FRAMES + FRAMES, WARM_FRAMES)
    ns = state.modules["navigation"]
    finite = bool(torch.isfinite(ns.agent_pos).all())
    navigating = ns.counters["navigating"]
    gap = G.min_gap(state, world, h)
    rate = NAV_WORLDS * 2 * NAV_CROSSING / (ms / 1e3)
    ops = op_counts(world, state, dev)
    pm = world.modules["physics"]
    busy = device_busy(step, state, {"navigation.update": lambda d: nav.update(state, d),
                                     "physics.update_parallel (no bodies)":
                                     lambda d: pm.update_parallel(state, d)})
    log(f"[9 width] {2 * NAV_CROSSING} agents (window {nav.separation_window}, dense up to "
        f"{nav.separation_window_threshold}) at W={NAV_WORLDS}: paths {paths:.2f} s, "
        f"{WARM_FRAMES + FRAMES} frames in {wall:.2f} s, launches {launches}, finite {finite}, "
        f"navigating min {int(navigating.min())}, closest agents {gap0:.4f} -> {gap:.4f} m")
    log(f"[9 width] {ms:.3f} ms/frame at W={NAV_WORLDS} = {rate:.4g} agent-steps/s; torch ops in "
        f"one frame {sum(ops.values())} = {ops}")
    if not _launched(launches, WARM_FRAMES + FRAMES, WARM_FRAMES + FRAMES) or not finite:
        raise AssertionError(f"width path: launches {launches}, finite {finite}")
    if int(navigating.min()) != 2 * NAV_CROSSING or not gap > G.MIN_GAP:
        raise AssertionError(f"width path: navigating {int(navigating.min())}, closest {gap}")
    cmp = compare_with_plain(engine, world, map_tensors(lambda t: t[:4].clone(), state), step,
                             extra=(("modules.navigation.", NAV_ATOL),
                                    ("modules.gui.", TRANSFORM_ATOL),
                                    ("modules.audio.", TRANSFORM_ATOL),
                                    ("modules.script.", SCRIPT_ATOL)))
    log(f"[9 width] 3 frames at W=4, card vs plain on the CPU: max abs err {cmp['errs']}")
    return {"ms": ms, "rate": rate, "ops": sum(ops.values()), "launches": launches,
            "cmp": cmp["errs"], "busy": busy}


def ptxas_report(log: str):
    """One line per kernel from nvcc's ptxas output: its name, then its
    stack, spills, registers and shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            name = ("BG grids" if "grids_kernel" in fn else "K2 compact" if "solve_kernelILb1" in fn
                    else "K2 in place"
                    if "solve_kernel" in fn else "K1" if "cull" in fn else "TF fold"
                    if "fold_kernel" in fn else "TF draw uniform" if "draw_kernelILb1" in fn
                    else "TF draw bits" if "draw_kernel" in fn
                    else "BJ pass" if "pass_kernelILb0" in fn
                    else "BJ warm pass" if "pass_kernelILb1" in fn
                    else next((f"BJ {part}" for part in ("mask", "scan", "body", "consts", "out")
                               if f"{part}_kernel" in fn), fn))
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def wide_problem(dev, num_worlds, replicate_state):
    """K2's operands at the largest shape the module makes: the slice world
    with 256 bodies, full_frame_world(2048, 0, 256, 0), its bodies piled up
    as in phase 4 (NB=256, C=7168), at `num_worlds` worlds."""
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world, pile_bodies

    _e, world, _r, _a, _p = full_frame_world(2048, 0, 256, 0)
    state = replicate_state(world.device_state(dev), num_worlds,
                            torch.Generator(device=dev).manual_seed(5))
    return world.modules["physics"].solver_problem(pile_bodies(state), DT)


def check_threefry(dev, num_worlds):
    """The Threefry kernel on the card against the plain version, bit for
    bit: one uniform draw under a twice-folded key batch (three launches),
    then the main path's draw, ``fold_uniform`` on `num_worlds` keys folded
    from a per-world counter whose words cross the sign bit, N_PARTICLES
    uniforms a key (three launches), against ``uniform_plain(fold_in_plain
    (...))`` on the card and against the CPU, which launches nothing.
    Returns the first 8 words of the first draw on each and the launches."""
    import torch

    from lumixengine_tpu_torch.core import random as prng

    words, wide, launches = {}, {}, {}
    counter = (torch.arange(num_worlds, dtype=torch.int64) * 2654435761 % 2**32).to(torch.int32)
    for where in (dev, torch.device("cpu")):
        before = prng.threefry_cuda.launches
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(0, where), 1234), torch.tensor(
            [7, -3], dtype=torch.int32, device=where))
        u = prng.uniform(key, (N_PARTICLES,))
        words[where.type] = u.view(torch.int32).cpu().numpy().view("uint32")
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0, where), 99), counter.to(where))
        wide[where.type] = prng.fold_uniform(keys, 5, (N_PARTICLES,)).view(torch.int32)
        launches[where.type] = prng.threefry_cuda.launches - before
        if where.type == "cuda":
            plain = prng.uniform_plain(prng.fold_in_plain(keys, 5), (N_PARTICLES,))
            bad = int((wide["cuda"] != plain.view(torch.int32)).sum())
            if bad:
                raise AssertionError(f"fold_uniform at [{num_worlds}, {N_PARTICLES}] differs from "
                                     f"the plain version on the card in {bad} words")
    cuda, cpu = words["cuda"], words["cpu"]
    if not (cuda == cpu).all():
        raise AssertionError(f"threefry differs on the card: {int((cuda != cpu).sum())} words")
    bad = int((wide["cuda"].cpu() != wide["cpu"]).sum())
    if bad:
        raise AssertionError(f"fold_uniform at [{num_worlds}, {N_PARTICLES}] differs between the "
                             f"card and the CPU in {bad} words")
    if launches.get("cuda") != 6 or launches["cpu"] != 0:
        raise AssertionError(f"threefry launches on the card and the CPU: {launches}")
    return {"cuda": cuda[0, :8].tolist(), "cpu": cpu[0, :8].tolist(), "launches": launches,
            "fold_uniform": [num_worlds, N_PARTICLES]}


def box_drop_operands(dev):
    """Phase 6's operands of the banded kernels on the 10k-box drop:
    box_drop_world at BJ_WORLDS worlds, BJ_LAND_FRAMES frames through the
    engine's step (the launches of BJ and of BG counted each frame), then
    the next frame's stage and solve operands caught on their way in:
    {"stage": (args, kwargs), "solve": (args, kwargs), "per_frame": [(BJ,
    BG) launches a frame]}."""
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import box_drop_world
    from lumixengine_tpu_torch.ops import physics_banded as PB
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, _, _ = box_drop_world(BANDED_BOXES, BANDED_CAPACITY, BANDED_WINDOW, seed=5)
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    state = replicate_state(world.device_state(dev), BJ_WORLDS,
                            torch.Generator(device=dev).manual_seed(5))
    per_frame = []
    for _ in range(BJ_LAND_FRAMES):
        before = (PB.solve_contacts_banded_cuda.launches, PB.banded_sweeps_cuda.launches)
        state = step(state, DT)
        per_frame.append((PB.solve_contacts_banded_cuda.launches - before[0],
                          PB.banded_sweeps_cuda.launches - before[1]))
    seen = {"per_frame": per_frame}
    solve, stage = PB.solve_contacts_banded_multi, PB.banded_sweeps

    def spy(name, fn):
        def call(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return call

    PB.solve_contacts_banded_multi, PB.banded_sweeps = spy("solve", solve), spy("stage", stage)
    try:
        step(state, DT)
    finally:
        PB.solve_contacts_banded_multi, PB.banded_sweeps = solve, stage
    return seen


def check_banded_jacobi(card, ops):
    """BJ on the 10k-box drop's own operands (box_drop_operands): the
    kernel against the plain version on the solve's operands (within
    BJ_PLAIN_ATOL, inactive slots' lambdas exactly 0, a second call
    bit-identical), its launches in each stepped frame, then both timed
    with CUDA events beside the bound."""
    import torch

    from lumixengine_tpu_torch.ops import physics_banded as PB

    per_frame = [bj for bj, _ in ops["per_frame"]]
    args, kw = ops["solve"]
    sweeps = args[5]

    def solve_kernel():
        return PB.solve_contacts_banded_cuda(*args, **kw)

    def solve_plain():
        return PB.solve_contacts_banded_multi_plain(*args, **kw)

    def outputs(r):
        return [r[0], r[1], *(t for lams in r[2] for t in lams)]

    got, again, ref = solve_kernel(), solve_kernel(), solve_plain()
    gap = max_err(outputs(got), outputs(ref))
    same = all(torch.equal(a, b) for a, b in zip(outputs(got), outputs(again)))
    stray = sum(int(torch.count_nonzero(lams[3 + j][~sw["p_active"].expand(lams[3].shape)]))
                for lams, sw in zip(got[2], sweeps) for j in range(3))
    w_, nb = args[0].shape[0], args[0].shape[-1]
    k, K = sweeps[0]["p_active"].shape[-3:-1]
    g = sum(sw["g_active"].shape[-2] for sw in sweeps if "g_active" in sw)
    n_pair = sum(int(sw["p_active"].sum()) for sw in sweeps)
    n_active = n_pair + sum(int(sw["g_active"].sum()) for sw in sweeps if "g_active" in sw)
    log(f"[6 BJ] box drop W={w_} NB={nb} sweeps={len(sweeps)} k={k} K={K} G={g}, {n_active} "
        f"active contacts ({n_pair} pair slots): max abs gap to the plain version {gap:.3e} "
        f"(limit {BJ_PLAIN_ATOL:g}), second call bit-identical {same}, nonzero lambdas on "
        f"inactive slots {stray}; launches a frame over {BJ_LAND_FRAMES} frames "
        f"{sorted(set(per_frame))}")
    if not gap <= BJ_PLAIN_ATOL or not same or stray:
        raise AssertionError(f"BJ: gap {gap}, bit-identical {same}, stray lambdas {stray}")
    if set(per_frame) != {2 * len(sweeps) + 3 + len(sweeps) * (1 + kw["iterations"])}:
        raise AssertionError(f"BJ launches a frame: {per_frame}")
    ms, plain_ms = alternate(solve_plain, solve_kernel, 3, BJ_REPS)
    nbytes = PB.banded_jacobi_bytes(w_, nb, len(sweeps), k, K, g, n_active)
    bound_ms, by = bound(nbytes, 0)
    log(f"[6 BJ] {card}: {ms:.4f} ms a solve over {BJ_REPS} calls, plain {plain_ms:.4f} ms, "
        f"{nbytes} bytes, bound {bound_ms:.4f} ms ({by}), share of bound {bound_ms / ms:.3f}")
    return {"max_abs_err": gap, "bit_identical": same, "launches_frame": per_frame[-1],
            "shape": [w_, nb, len(sweeps), k, K, g],
            "n_active": n_active, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / ms}


def check_banded_grids(card, ops):
    """BG on the 10k-box drop's own stage operands (box_drop_operands): the
    kernel against the plain version (flags equal except on slots whose
    plain depth lies within BG_DEPTH_TIE of 0; active slots' point, normal
    and depth within BG_PLAIN_ATOL; friction, restitution, the warm-start
    lambdas, the ground grids and the certificate exact; the active count
    the sum of the kernel's flags), a second call bit-identical, its
    launches in each stepped frame (one a sweep), then both timed with CUDA
    events beside the bound (physics_banded.banded_grids_bytes)."""
    import torch

    from lumixengine_tpu_torch.ops import physics_banded as PB

    per_frame = [bg for _, bg in ops["per_frame"]]
    args, kw = ops["stage"]

    def run_kernel():
        return PB.banded_sweeps_cuda(*args, **kw)

    def run_plain():
        return PB.banded_sweeps_plain(*args, **kw)

    def grids(r):
        return ([sw[key] for sw in r[0] for key in PB.PAIR_KEYS + PB.GROUND_KEYS if key in sw]
                + [t for w in r[1] or () for v in w.values() for t in v])

    got, again, ref = run_kernel(), run_kernel(), run_plain()
    same = all(torch.equal(a, b) for a, b in zip(grids(got), grids(again)))
    flips = far = stray = 0
    gap = 0.0
    own = torch.zeros_like(got[3])
    for a, b in zip(got[0], ref[0]):
        ka, ra = a["p_active"], b["p_active"]
        flips += int((ka != ra).sum())
        far += int(((ka != ra) & (b["p_depth"].abs() > BG_DEPTH_TIE)).sum())
        both = (ka & ra).unsqueeze(-4)
        for key in ("p_point", "p_normal"):
            gap = max(gap, float(torch.where(both, (a[key] - b[key]).abs(), 0.0).max()))
        gap = max(gap, float(torch.where(ka & ra, (a["p_depth"] - b["p_depth"]).abs(), 0.0).max()))
        stray += sum(int(not torch.equal(a[key], b[key]))
                     for key in ("p_fric", "p_rest") + PB.GROUND_KEYS if key in a)
        own = own + ka.sum(dim=(-3, -2, -1)).to(own.dtype)
        if "g_active" in a:
            own = own + a["g_active"].sum(dim=(-2, -1)).to(own.dtype)
    stray += sum(int(not torch.equal(x, y)) for w, v in zip(got[1] or (), ref[1] or ())
                 for key in w for x, y in zip(w[key], v[key]))
    stray += int(not torch.equal(got[2], ref[2])) + int(not torch.equal(got[3], own))
    named = inspect.signature(PB.banded_sweeps_plain).bind(*args, **kw).arguments
    w_, nb, n_s = named["pos"].shape[0], named["pos"].shape[-1], len(named["orders"])
    k, K, warm = named["k"], named["K"], named["carry"] is not None
    g = got[0][0]["g_active"].shape[-2] if "g_active" in got[0][0] else 0
    n_active = int(got[3].sum())
    log(f"[6 BG] box drop W={w_} NB={nb} sweeps={n_s} k={k} K={K} G={g}, {n_active} active "
        f"contacts ({int(ref[3].sum())} plain): flags differing {flips} ({far} away from "
        f"depth 0 by more than {BG_DEPTH_TIE:g}), largest gap on slots active in both "
        f"{gap:.3e} (limit {BG_PLAIN_ATOL:g}), exact outputs differing {stray}, second call "
        f"bit-identical {same}; launches a frame over {BJ_LAND_FRAMES} frames "
        f"{sorted(set(per_frame))}")
    if far or stray or not gap <= BG_PLAIN_ATOL or not same:
        raise AssertionError(f"BG: flags {far}, exact outputs {stray}, gap {gap}, same {same}")
    if set(per_frame) != {n_s}:
        raise AssertionError(f"BG launches a frame: {per_frame}")
    del got, again, ref
    ms, plain_ms = alternate(run_plain, run_kernel, 3, BJ_REPS)
    nbytes = PB.banded_grids_bytes(w_, nb, n_s, k, K, g, warm=warm)
    bound_ms, by = bound(nbytes, 0)
    log(f"[6 BG] {card}: {ms:.4f} ms a stage over {BJ_REPS} calls, plain {plain_ms:.4f} ms, "
        f"{nbytes} bytes, bound {bound_ms:.4f} ms ({by}), share of bound {bound_ms / ms:.3f}")
    return {"max_abs_err": gap, "flags_at_ties": flips, "bit_identical": same,
            "launches_frame": per_frame[-1], "shape": [w_, nb, n_s, k, K, g],
            "n_active": n_active, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / ms}


def run_path(name, built, num_worlds, dev, replicate_state, map_tensors, step=None, views=False,
             passes=False):
    """FRAMES frames of one path at `num_worlds` worlds on the card, timed
    and checked, then the 3-frame compare against the CPU. The checks follow
    the world's modules: contacts where there is physics, characters where
    there is animation, particles where there is an emitter. With `passes`
    each frame is followed by the shadow and cluster passes (the render
    config); with `views` prepare_view, record_frame and the passes are
    checked and counted after the timed frames and in the compare."""
    import torch

    engine, world = built[0], built[1]
    rm = world.modules["renderer"]
    has_physics, an = "physics" in world.modules, world.modules.get("animation")
    if step is None:
        step = engine.build_step(world, dev, extra=rm.cull_pass)
    frame = render_frame(step, rm) if passes else step
    state = replicate_state(world.device_state(dev), num_worlds,
                            torch.Generator(device=dev).manual_seed(0))
    start = state
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _zero_launches()
    t0 = time.perf_counter()
    for f in range(FRAMES):
        if f == WARM_FRAMES:
            ev0.record()
        state = frame(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    ms_frame = ev0.elapsed_time(ev1) / (FRAMES - WARM_FRAMES)
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    rs = state.modules["renderer"]
    visible = rs.counters["visible_count"]
    alive = rs.counters["particles_alive"]
    n_inst = int((rm.statics().mi_slots >= 0).sum())
    facts = [f"{FRAMES} frames in {wall:.2f} s", f"launches {launches}", f"finite {finite}",
             f"visible min/mean {int(visible.min())}/{float(visible.float().mean()):.1f} of "
             f"{n_inst}"]
    if passes:
        facts.append(f"shadow casters + cluster lights + overflow summed over the frames "
                     f"{int(frame.probe)}")
    if has_physics:
        active = state.modules["physics"].counters["active_contacts"]
        facts.append(f"active contacts {int(active.sum())} (worlds with contacts "
                     f"{int((active > 0).sum())})")
    n_char = 0
    if an is not None:
        ams = state.modules["animation"]
        animated = ams.counters["animated"]        # the animables, as the reference counts
        posed = (ams.pose_pos != 0).any(dim=-3).any(dim=-2).sum(dim=-1)  # pool columns written
        moved = _root_motion(world, start, state)
        n_char = len(an.animables) + len(an.animators)
        facts.append(f"characters animated min/max {int(posed.min())}/{int(posed.max())} "
                     f"(animables {int(animated.min())}); animators moved min/max "
                     f"{moved[0]:.3f}/{moved[1]:.3f} m")
    cap = sum(ps.caps[e] for _k, (_e, ps) in rm.particle_emitters.items() for e in ps.caps)
    if cap:
        facts.append(f"particles alive min/max {int(alive.min())}/{int(alive.max())} of {cap}")
    log(f"[5 {name}] W={num_worlds}: " + "; ".join(facts))
    # K1 and K2 once a frame; the Threefry kernel at least once a frame where there are
    # emitters (the frame's key fold), never where there are none
    draws = launches["TF"] >= FRAMES if rm.particle_emitters else launches["TF"] == 0
    if not _launched(launches, FRAMES, FRAMES if has_physics else 0) or not draws:
        raise AssertionError(f"the path's kernels launched {launches} times in {FRAMES} frames")
    if not finite or (n_inst and int(visible.min()) <= 0):
        raise AssertionError("state is not finite, or no instance is visible")
    if has_physics and int(active.sum()) == 0:
        raise AssertionError("no contacts")
    if passes and int(frame.probe) <= 0:
        raise AssertionError("the shadow and cluster passes found no caster and no light")
    if an is not None and not (bool((animated == len(an.animables)).all())
                               and bool((posed == n_char).all())):
        raise AssertionError(f"characters animated {posed.unique().tolist()} (expected {n_char};"
                             f" animables {animated.unique().tolist()})")
    if an is not None and len(an.animators) and not moved[2]:
        raise AssertionError(f"root motion did not move the animators: {moved}")
    if cap and not (int(alive.min()) > 0 and int(alive.max()) <= cap):
        raise AssertionError(f"particles alive {int(alive.min())}..{int(alive.max())} "
                             f"(capacity {cap})")
    del start
    k1 = k1_on_path(name, world, state)
    ops = op_counts(world, state, dev, passes=passes)
    log(f"[5 {name}] torch ops dispatched in one frame at W={num_worlds} (views excluded, "
        f"K1/K2 launches not counted): {sum(ops.values())} = {ops}")
    out = {"ms": ms_frame, "worlds": num_worlds, "units": world.capacity, "unit": "entity",
           "launches": launches, "ops": sum(ops.values()), "k1": k1}
    if views:
        out.update(view_checks(name, world, state, map_tensors))
        out["clusters"] = time_clusters(world, state)
    if num_worlds >= 4:
        cmp_state = map_tensors(lambda t: t[:4].clone(), state)
    else:   # a one-world path: its end state tiled to 4 worlds, which diverge
        cmp_state = replicate_state(map_tensors(lambda t: t[0], state), 4,
                                    torch.Generator(device=dev).manual_seed(4))
    del state
    cmp = compare_with_plain(engine, world, cmp_state, step, views=views)
    log(f"[5 {name}] {n_char} characters; 3 frames at W={cmp_state.local.pos.shape[0]}, card vs "
        f"plain on the CPU: max abs err {cmp['errs']}, boundary flips {cmp['flips']}, kill flips "
        f"{cmp['kills']}" + (f", view/shadow/cluster flips {cmp['view_flips']}" if views else ""))
    return out


def render_frame(step, rm):
    """`step` followed by the render config's two per-view passes on every
    world, as bench.py --config render runs them: 4 shadow cascades and the
    cluster pass. Their caster counts, cluster counts and overflow are
    summed into `frame.probe`, a device scalar read after the frames."""
    from lumixengine_tpu_torch.renderer import clusters, shadows

    statics = rm.statics()

    def frame(state, dt):
        state = step(state, dt)
        sv = shadows.shadow_pass(state, rm, light_dir=LIGHT_DIR, statics=statics)
        cl = clusters.fill_clusters(state, rm, statics=statics)
        frame.probe = frame.probe + (sv.caster_count.sum() + cl.count.sum() + cl.overflow.sum())
        return state

    frame.probe = 0
    return frame


def view_checks(name, world, state, map_tensors):
    """One prepare_view in each sort mode on the batch (K1 once each, with
    the launch counts set to 0 just before and read just after), the draw
    order checked on the card, record_frame on world 0, and the torch ops
    of prepare_view and shadow_pass at this W (the cluster pass's in
    time_clusters)."""
    import torch

    from lumixengine_tpu_torch.renderer import draw_stream, pipeline, shadows

    rm = world.modules["renderer"]
    torch.cuda.synchronize()
    _zero_launches()
    views = {mode: pipeline.prepare_view(state, rm, sort_mode=mode)
             for mode in (pipeline.SORT_MATERIAL, pipeline.SORT_DEPTH)}
    torch.cuda.synchronize()
    launches = _launches()
    if not _launched(launches, 2, 0):
        raise AssertionError(f"prepare_view must launch K1 once a call: {launches}")
    for mode, v in views.items():
        order = v.order.long()
        hi, lo = v.sort_key.gather(-1, order), v.sort_key_lo.gather(-1, order)
        ascending = (hi[..., 1:] > hi[..., :-1]) | ((hi[..., 1:] == hi[..., :-1])
                                                   & (lo[..., 1:] >= lo[..., :-1]))
        rank = torch.arange(order.shape[-1], device=order.device)
        first = v.visible.gather(-1, order) == (rank < v.visible_count[..., None])
        if not (bool(ascending.all()) and bool(first.all()) and torch.equal(
                v.visible_count, state.modules["renderer"].counters["visible_count"])):
            raise AssertionError(f"prepare_view (sort mode {mode}): the draw order is not the keys'")
    stream = draw_stream.record_frame(map_tensors(lambda t: t[0], views[pipeline.SORT_MATERIAL]),
                                      state.modules["renderer"], rm)
    layers = {"prepare_view": lambda: pipeline.prepare_view(state, rm),
              "shadow_pass": lambda: shadows.shadow_pass(state, rm, LIGHT_DIR)}
    ops = {k: count_ops(fn)[1] for k, fn in layers.items()}
    ms = {k: float(f"{cuda_time(fn, 5):.4f}") for k, fn in layers.items()}
    log(f"[5 {name}] prepare_view in both sort modes: launches {launches}, draw order ascending "
        f"in its keys with the visible instances first; record_frame on world 0: "
        f"{len(stream.commands)} commands {[c.op for c in stream.commands]}; at "
        f"W={state.alive.shape[0]}, torch ops a call {ops}, ms a call {ms}")
    return {"view_launches": launches["K1"], "layer_ops": ops, "layer_ms": ms}


def time_clusters(world, state):
    """The cluster pass at the path's W on the card: ms a call (CUDA events
    over 5 calls), the host's enqueue time of one call, its torch ops, and
    its bound: the bytes it must move (camera, the live lights' positions
    and ranges and the light mask read once; lists, counts and overflow
    written once) over 3.35 TB/s, or its float operations (per world,
    cluster and live light: 3 axes of clamp (2), subtract, square, add, and
    the range compare) over 67 TFLOP/s, whichever is longer. A masked light
    slot's test is decided by the mask alone, so it needs no arithmetic;
    the pass as written computes every slot of the padded light axis, and
    that count is returned beside the bound (`flops_padded`)."""
    import torch

    from lumixengine_tpu_torch.renderer import clusters

    rm = world.modules["renderer"]
    st = rm.statics()

    def call():
        return clusters.fill_clusters(state, rm, statics=st)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ms = cuda_time(call, 5)
    _, n_ops = count_ops(call)
    w = state.alive.shape[0]
    c = 1
    for n in clusters.GRID:
        c *= n
    n_l = rm.point_lights.capacity
    n_live = int(st.pl_mask.sum())
    l_pad = -(-n_l // clusters.WORD) * clusters.WORD
    k = clusters.MAX_LIGHTS_PER_CLUSTER
    nbytes = w * (7 + 4) * 4 + w * n_live * (3 + 1) * 4 + n_l + w * c * (k + 1) * 4 + w * 4
    flops, flops_padded = w * c * n_live * 16, w * c * l_pad * 16
    bound_ms, by = bound(nbytes, flops)
    return {"ms": ms, "enqueue_ms": enqueue_ms, "ops": n_ops, "W": w, "C": c, "L": n_l,
            "L_live": n_live, "L_pad": l_pad, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": by, "flops_padded": flops_padded,
            "bound_ms_padded": bound(nbytes, flops_padded)[0]}


def run_attachments(dev, replicate_state):
    """The skinned crowd at 4 characters with two bone attachments (a sword
    on bone 5 of an animable, a lamp with an offset rotation on bone 9 of an
    animator), replicated to 4 worlds: 3 frames on the card against the CPU;
    each attachment's local transform is its bone's pose ∘ offset."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.core import math as lm
    from lumixengine_tpu_torch.models.demo_scenes import skinned_crowd_world

    engine, world, _r, _a = skinned_crowd_world(4)
    rm, an = world.modules["renderer"], world.modules["animation"]
    parents = (int(an.animables.entity[an.animables.entity >= 0][0]),
               int(an.animators.entity[an.animators.entity >= 0][0]))
    offsets = (((0.0, 0.2, 0.0), (0.0, 0.0, 0.0, 1.0)),
               ((0.1, 0.0, -0.3), (0.0, float(np.sin(0.4)), 0.0, float(np.cos(0.4)))))
    attached = []
    for parent, bone, (op, orot) in zip(parents, (5, 9), offsets):
        e = world.create_entity()
        world.create_component(e, "bone_attachment", parent_entity=parent, bone=bone,
                               offset_pos=op, offset_rot=orot)
        attached.append(e)
    step = engine.build_step(world, dev, extra=rm.cull_pass)
    state = replicate_state(world.device_state(dev), 4, torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    _zero_launches()
    step(state, DT)
    torch.cuda.synchronize()
    launches = _launches()
    k1 = k1_on_path("attachments", world, state)
    cmp = compare_with_plain(engine, world, state, step)
    end, ams = cmp["state"], cmp["state"].modules["animation"]
    err = 0.0
    for e, parent, bone, (op, orot) in zip(attached, parents, (5, 9), offsets):
        col = (an.pool_col_animable(an.animables.slot_of(parent)) if parent in an.animables
               else an.pool_col_animator(an.animators.slot_of(parent)))
        bp, br = ams.pose_pos[..., :, bone, col], ams.pose_rot[..., :, bone, col]
        want_p = bp + lm.quat_rotate(br, torch.tensor(op, device=dev))
        want_r = lm.quat_mul(br, torch.tensor(orot, device=dev))
        slot = world.slot(e)
        err = max(err, max_err([end.local.pos[..., :, slot], end.local.rot[..., :, slot]],
                               [want_p, want_r]))
    log(f"[5 attachments] skinned_crowd_world(4) + 2 bone attachments at W=4: launches in a frame "
        f"{launches};"
        f" 3 frames card vs plain on the CPU: max abs err {cmp['errs']}; attachment local vs "
        f"bone pose ∘ offset on the card: {err:.3e}")
    if not _launched(launches, 1, 0) or not err <= TRANSFORM_ATOL:
        raise AssertionError(f"bone attachments: launches {launches}, pose error {err}")
    return {"launches": launches, "err": err, "k1": k1}


def run_boxes(dev):
    """The 10k-box drop: two runs of BOX_STEPS steps on the card (the second
    timed with CUDA events), the certificates summed on the card and read
    once; the settle gate at the end; the ops of one step; 3 steps from step
    BOX_COMPARE_AT, card vs CPU."""
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import box_drop_pile

    step, (pos, rot, vel, ang, carry), consts = box_drop_pile(N_BOXES, device=dev)
    dt = torch.tensor(DT, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    drop, miss, max_cand, max_active = zero, zero, zero, zero
    walls = []
    for run in range(2):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for i in range(BOX_STEPS):
            if run == 0 and i == BOX_COMPARE_AT:
                mid = (pos, rot, vel, ang, carry)  # the step makes new tensors: no copy needed
            pos, rot, vel, ang, ctr, carry = step(pos, rot, vel, ang, dt, carry, consts)
            drop = drop + ctr["slot_drop"]
            miss = miss + ctr["column_miss"]
            max_cand = torch.maximum(max_cand, ctr["max_candidates"])
            max_active = torch.maximum(max_active, ctr["active_contacts"])
        ev1.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            v2 = (vel * vel).sum(0) + (ang * ang).sum(0)
            half = {"ke": float(v2.sum()), "asleep": int((v2 == 0.0).sum()),
                    "lowest": float(pos[1].min()), "below": int((pos[1] < BOX_Y_MIN).sum())}
    ms = ev0.elapsed_time(ev1) / BOX_STEPS
    finite = all(bool(torch.isfinite(t).all()) for t in (pos, rot, vel, ang))
    v2 = (vel * vel).sum(0) + (ang * ang).sum(0)
    end = {"ke_end": float(v2.sum()), "sleeping_end": int((v2 == 0.0).sum())}
    y_min = float(pos[1].min())
    asleep = v2 == 0.0
    y_sleep = float(torch.where(asleep, pos[1], float("inf")).min())
    deep = pos[1] < BOX_Y_MIN
    n_deep, n_deep_awake = int(deep.sum()), int((deep & ~asleep).sum())
    log(f"[6 boxes] {N_BOXES} boxes, 2 x {BOX_STEPS} steps in {walls[0]:.2f} + {walls[1]:.2f} s "
        f"(timed run {ms:.3f} ms/step = {N_BOXES / (ms / 1e3):.4g} body-steps/s); at step "
        f"{BOX_STEPS}: {half}; at step {2 * BOX_STEPS}: slot_drop {int(drop)}, column_miss "
        f"{int(miss)}, finite {finite}, lowest centre {y_min:.4f} m (of a sleeping box "
        f"{y_sleep:.4f} m), boxes below {BOX_Y_MIN} m {n_deep} ({n_deep_awake} awake), max "
        f"candidates "
        f"{int(max_cand)}, active contacts at the end {int(ctr['active_contacts'])} (max "
        f"{int(max_active)}), sleeping {int(ctr['sleeping'])}; end state {end} (the "
        f"reference's recorded run: {BOX_REFERENCE_END})")
    if int(drop) or int(miss) or not finite:
        raise AssertionError("the box drop fired a certificate or is not finite")
    if not (y_sleep > BOX_SLEEP_Y_MIN and y_min > BOX_LOWEST_MIN and n_deep <= BOX_BELOW_MAX):
        raise AssertionError(f"a box sank to {y_min} m (limit {BOX_LOWEST_MIN}), a sleeping one "
                             f"to {y_sleep} m (limit {BOX_SLEEP_Y_MIN}); {n_deep} boxes below "
                             f"{BOX_Y_MIN} m (limit {BOX_BELOW_MAX})")
    if not (end["ke_end"] < BOX_KE_MAX and end["sleeping_end"] > BOX_ASLEEP_MIN * N_BOXES):
        raise AssertionError(f"the pile did not come to rest: {end}")
    _, n_ops = count_ops(lambda: step(*mid[:4], dt, mid[4], consts))
    # the step never waits for the card: any synchronizing call raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*mid[:4], dt, mid[4], consts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"[6 boxes] torch ops dispatched in one step: {n_ops}; one step ran with every "
        f"synchronizing CUDA call an error")

    cpu_consts = step.init_consts("cpu")
    gpu, cpu = mid, _to_cpu(mid)
    errs = {}
    for _ in range(3):
        *gb, gctr, gcarry = step(*gpu[:4], dt, gpu[4], consts)
        *cb, cctr, ccarry = step(*cpu[:4], torch.tensor(DT, dtype=torch.float32), cpu[4],
                                 cpu_consts)
        gpu, cpu = (*gb, gcarry), (*cb, ccarry)
        for name, g, c, atol in zip(("pos", "rot", "vel", "angvel"), gb, cb,
                                    (BODY_POS_ATOL, BODY_POS_ATOL, BODY_VEL_ATOL,
                                     BODY_VEL_ATOL)):
            err = float((g.cpu() - c).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
            if not err <= atol:
                raise AssertionError(f"boxes {name}: card vs plain {err} > {atol}")
        certs = {k: (int(gctr[k]), int(cctr[k])) for k in ("slot_drop", "column_miss")}
        if any(a != b for a, b in certs.values()):
            raise AssertionError(f"boxes certificates differ, card vs CPU: {certs}")
    log(f"[6 boxes] 3 steps from step {BOX_COMPARE_AT}, card vs plain on the CPU: max abs err "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }, active contacts "
        f"{int(gctr['active_contacts'])} / {int(cctr['active_contacts'])}, certificates {certs}")
    return {"ms": ms, "ops": n_ops, **end}


def _golden(name):
    import numpy as np

    with np.load(os.path.join(GOLDEN_DIR, f"golden_{name}.npz")) as f:
        return dict(f)


def _zero_launches():
    from lumixengine_tpu_torch.core import random as prng
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import physics_banded as PB
    from lumixengine_tpu_torch.ops import solver as S

    cull.frustum_cull_cuda.launches = 0
    S.solve_cuda.launches = 0
    prng.threefry_cuda.launches = 0
    PB.solve_contacts_banded_cuda.launches = 0
    PB.banded_sweeps_cuda.launches = 0


def _launches():
    from lumixengine_tpu_torch.core import random as prng
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import physics_banded as PB
    from lumixengine_tpu_torch.ops import solver as S

    return {"K1": cull.frustum_cull_cuda.launches, "K2": S.solve_cuda.launches,
            "TF": prng.threefry_cuda.launches, "BJ": PB.solve_contacts_banded_cuda.launches,
            "BG": PB.banded_sweeps_cuda.launches}


def _launched(launches, k1: int, k2: int) -> bool:
    """Whether K1 and K2 launched `k1` and `k2` times. The Threefry kernel's
    launches follow the content's random draws: they are reported beside
    them, and held where the path says how many it draws."""
    return launches["K1"] == k1 and launches["K2"] == k2


def run_goldens(dev):
    """The nine committed goldens (tests/data/golden_*.npz) at W=1 on the
    card for their full step counts, each held to the bounds of the JAX
    package's tests/test_golden_trajectories.py, capsule_stack as the
    ensemble of physics_scenes.golden_ensemble (its outcome is decided by
    rounding, in the JAX package too; its world 0 starts as the golden). K2
    launches once a step in every world that has a contact stream. Then K2
    against its plain version on each such world's contact set at its last
    step (the ensemble's for capsule_stack)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S

    expected, k2_err, t0 = 0, 0.0, time.perf_counter()
    torch.cuda.synchronize()
    _zero_launches()
    finals = []
    for name in PS.GOLDEN_NAMES:
        if name == "capsule_stack":
            continue          # the ensemble below, world 0 as the golden starts
        g = _golden(name)
        engine, world, state, slots = PS.golden_world(g, dev)
        pm = world.modules["physics"]
        st = pm.statics()
        steps = int(g["steps"])
        state, traj = PS.run_recorded(engine.build_step(world, dev), state,
                                      slots[PS.GOLDEN_RECORD.get(name, 0)], steps)
        expected += steps * bool(st.ground_plane or len(st.pair_a))
        finals.append((name, g, pm, state, traj, slots))
    cap = _golden("capsule_stack")
    engine, world, ens, cap_slots = PS.golden_ensemble(cap, PS.CAPSULE_WORLDS, PS.CAPSULE_EPS,
                                                       dev)
    step = engine.build_step(world, dev)
    for _ in range(int(cap["steps"])):
        ens = step(ens, DT)
    expected += int(cap["steps"])
    torch.cuda.synchronize()
    launches, wall = _launches(), time.perf_counter() - t0
    for name, g, pm, state, traj, slots in finals:
        ms = state.modules["physics"]
        if name == "tumbling":
            got = PS.check_tumbling(g, ms.rot.cpu().numpy(), slots[0])
        else:
            got = PS.check_golden(name, g, traj.cpu().numpy(), ms.pos.cpu().numpy(),
                                  ms.vel.cpu().numpy(), slots)
        err = None
        if pm.statics().ground_plane or len(pm.statics().pair_a):
            prob = pm.solver_problem(state, DT)
            err = max_err(S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS),
                          S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS))
            if not err <= S.K2_PLAIN_ATOL:
                raise AssertionError(f"K2 on golden {name}: {err} vs plain")
            k2_err = max(k2_err, err)
        shown = {k: (float(f"{v:.4g}") if isinstance(v, float) else v) for k, v in got.items()}
        log(f"[7 golden] {name}: {int(g['steps'])} steps at W=1, NB={ms.pos.shape[-1]}, within "
            f"the bounds of tests/test_golden_trajectories.py: {shown}; K2 vs plain "
            f"{'no contact stream' if err is None else f'{err:.3e}'}")
    ens_pm = world.modules["physics"]
    prob = ens_pm.solver_problem(ens, DT)
    cap_err = max_err(S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS),
                      S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS))
    if not cap_err <= S.K2_PLAIN_ATOL:
        raise AssertionError(f"K2 on the capsule_stack ensemble: {cap_err} vs plain")
    k2_err = max(k2_err, cap_err)
    ms = ens.modules["physics"]
    pos = ms.pos.cpu().numpy()
    holds = PS.golden_passes("capsule_stack", cap, pos, ms.vel.cpu().numpy(), cap_slots)
    statics = np.asarray(cap["init_pos"][:2], np.float32).T
    moved = int((pos[:, :, cap_slots[:2]] != statics[None]).any(axis=(1, 2)).sum())
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(ens))
    need = PS.CAPSULE_REFERENCE_PASSES - PS.CAPSULE_PASS_MARGIN
    log(f"[7 golden] capsule_stack ensemble: {PS.CAPSULE_WORLDS} worlds, N(0, "
        f"{PS.CAPSULE_EPS:g}^2) m/s on the top capsule's start velocity (world 0 none): "
        f"{int(holds.sum())} within the bounds (world 0 {bool(holds[0])}; the JAX package "
        f"{PS.CAPSULE_REFERENCE_PASSES} on the CPU, at least {need} required), worlds with a "
        f"static moved {moved}, finite {finite}; K2 vs plain on its end contact set "
        f"{cap_err:.3e}")
    log(f"[7 golden] nine goldens and the ensemble in {wall:.2f} s, launches {launches} "
        f"(K2 expected {expected})")
    if not _launched(launches, 0, expected):
        raise AssertionError(f"the goldens' launches {launches}, expected K2 {expected}")
    if int(holds.sum()) < need or moved or not finite:
        raise AssertionError(f"capsule_stack ensemble: {int(holds.sum())} within the bounds, "
                             f"{moved} moved statics, finite {finite}")
    return {"launches": launches, "k2_err": k2_err}


def golden_gap(name, dev):
    """Golden `name` at W=1 stepped on the card and on the CPU side by side
    for the first GAP_STEPS steps of its arc: each physics field's largest
    gap, the first step where
    it passes GAP_LIMIT and the first step where the two differ at all; then
    that step again from the CPU's state before it on both devices, op by op
    (first_divergent_op), and K2 against the plain solve on its contact set
    there."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S

    g = _golden(name)
    engine, world, gpu, _slots = PS.golden_world(g, dev)
    pm = world.modules["physics"]
    gstep, cstep = engine.build_step(world, dev), engine.build_step(world, "cpu")
    cpu = gpu.to("cpu")
    fields = ("pos", "rot", "vel", "angvel")

    def rows(state):
        ph = state.modules["physics"]
        return torch.cat([getattr(ph, f).reshape(-1) for f in fields])

    cpu_states, grows, crows = [cpu], [], []
    steps = min(int(g["steps"]), GAP_STEPS)
    for _ in range(steps):
        gpu, cpu = gstep(gpu, DT), cstep(cpu, DT)
        grows.append(rows(gpu))
        crows.append(rows(cpu))
        cpu_states.append(cpu)
    sizes = [getattr(cpu.modules["physics"], f).numel() for f in fields]
    diff = (torch.stack(grows).cpu() - torch.stack(crows)).abs()
    gap = torch.stack([d.amax(dim=-1) for d in diff.split(sizes, dim=-1)], dim=-1)  # [steps, fields]

    def first(mask):
        hit = torch.nonzero(mask).flatten()
        return int(hit[0]) + 1 if len(hit) else None

    out = {"steps": steps,
           "max_gap": {f: float(f"{float(gap[:, i].max()):.4g}") for i, f in enumerate(fields)},
           f"first_step_over_{GAP_LIMIT:g}": {f: first(gap[:, i] > GAP_LIMIT)
                                               for i, f in enumerate(fields)},
           "first_step_differing": first(gap.amax(dim=-1) > 0)}
    k = out["first_step_differing"]
    if k is not None:
        before = cpu_states[k - 1]
        out["first_op"] = first_divergent_op(cstep, gstep, before, dev)
        st = pm.statics()
        if st.ground_plane or len(st.pair_a):
            prob = pm.solver_problem(before.to(dev), DT)
            out["k2_vs_plain_there"] = max_err(
                [t.cpu() for t in S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)],
                S.solve_plain(pm.solver_problem(before, DT), ITERATIONS, POSITION_ITERATIONS))
    log(f"[7 gap] {name}: card vs CPU, {out}")
    return out


def first_divergent_op(cpu_step, gpu_step, state, dev):
    """One step from the same state on the CPU and on the card, each torch op
    recorded with its outputs: the first op whose outputs differ, where the
    port calls it, and by how much. Both sides take the plain contact solve
    here, so that the two op streams line up (K2 is one library call, not a
    torch op; its own gap is measured beside)."""
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from lumixengine_tpu_torch.ops import solver as S

    root = os.path.dirname(os.path.abspath(__file__))

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            # views, fresh allocations and host-to-device constant copies
            # (the card's step copies constants the CPU's uses in place)
            if not (getattr(func, "is_view", False) or "empty" in name
                    or name.startswith(("aten._to_copy", "aten.lift_fresh"))):
                where = next((f"{os.path.relpath(fr.filename, root)}:{fr.lineno}"
                              for fr in reversed(traceback.extract_stack())
                              if "lumixengine_tpu_torch" in fr.filename), "?")
                outs = [t.detach().cpu().clone() for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)]
                self.ops.append((name, outs, where))
            return out

    solve = S.solve
    S.solve = S.solve_plain
    try:
        recs = []
        for step, where in ((cpu_step, "cpu"), (gpu_step, dev)):
            with Record() as rec:
                step(state.to(where), torch.tensor(DT, dtype=torch.float32, device=where))
            recs.append(rec.ops)
    finally:
        S.solve = solve
    def same(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)

    for i, ((fc, tc, at), (fg, tg, _)) in enumerate(zip(*recs)):
        if fc != fg:
            return {"op_index": i, "streams_part": (fc, fg), "ops": len(recs[0])}
        for a, b in zip(tc, tg):
            if not same(a, b):
                d = (a.double() - b.double()).abs()
                return {"op_index": i, "op": fc, "at": at, "ops": len(recs[0]),
                        "max_abs_diff": float(d.max()), "elements_differing": int((d > 0).sum())}
    return {"op_index": None, "ops": len(recs[0])}


def run_farm(name, dev, replicate_state):
    """Golden `name` replicated to FARM_WORLDS diverging worlds, FARM_FRAMES
    frames timed with CUDA events; K2 on the farm's contact set against its plain
    version, timed beside it and against its bound (k2_on_state)."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS

    g = _golden(name)
    engine, world, state, _slots = PS.golden_world(g, dev)
    pm = world.modules["physics"]
    step = engine.build_step(world, dev)
    state = replicate_state(state, FARM_WORLDS, torch.Generator(device=dev).manual_seed(6))
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    for f in range(FARM_FRAMES):
        if f == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    launches = _launches()
    ms = ev0.elapsed_time(ev1) / (FARM_FRAMES - WARM_FRAMES)
    phys = state.modules["physics"]
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    n_dyn = int(pm.statics().dyn_mask.sum())
    active = phys.counters["active_contacts"]
    _, n_ops = count_ops(lambda: step(state, DT))
    if not _launched(launches, 0, FARM_FRAMES) or not finite:
        raise AssertionError(f"farm {name}: launches {launches}, finite {finite}")
    # a capsule takes a sphere's inertia, as in the reference, and in a few
    # perturbed capsule worlds the top capsule spins up to hundreds of rad/s
    # (the JAX package too, from the same states): k2_on_state leaves out
    # the worlds where a body in contact moves above SANE_SPEED
    k2 = k2_on_state(pm, state, f"the {name} farm")
    rate = FARM_WORLDS * n_dyn / (ms / 1e3)
    log(f"[7 farm] {name}: W={FARM_WORLDS}, {n_dyn} dynamic bodies a world, {FARM_FRAMES} frames: "
        f"{ms:.3f} ms/frame = {rate:.4g} body-steps/s, {n_ops} torch ops/frame, launches "
        f"{launches}, finite {finite}, active contacts {int(active.sum())} (worlds with "
        f"contacts {int((active > 0).sum())}); K2 on its contact set W={k2['W']} NB={k2['NB']} "
        f"C={k2['C']} (active {k2['active']}): {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, "
        f"{k2['bytes']} bytes, bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}), max abs err vs "
        f"plain {k2['max_abs_err']:.3e} on the {k2['worlds_compared']} worlds without a body in "
        f"contact above {SANE_SPEED:g} m/s or rad/s")
    return {"ms": ms, "rate": rate, "ops": n_ops, "launches": launches, "k2": k2}


def run_banded(dev):
    """PhysicsModule's banded branch, which `auto` picks above 256 actor
    slots: BANDED_BOXES boxes on the bench's grid at BANDED_CAPACITY slots
    with a sweep window of BANDED_WINDOW,
    BANDED_STEPS steps at W=1, the window certificate summed on the card and
    read once (must be 0), the state finite, no box centre below
    BOX_LOWEST_MIN; then a block of BANDED_COMPARE_BOXES boxes run
    BANDED_COMPARE_AT steps on the card and 3 more on the card and on the
    CPU, within BODY_POS_ATOL / BODY_VEL_ATOL with equal certificates and
    active-contact counts."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS

    engine, world = PS.box_block(BANDED_BOXES, BANDED_CAPACITY, neighbors=BANDED_WINDOW)
    pm = world.modules["physics"]
    if not pm.statics().sap:
        raise AssertionError("the box block did not take the banded branch")
    occ = torch.as_tensor(pm.statics().occupied, device=dev)
    step = engine.build_step(world, dev)
    state = world.device_state(dev)
    miss = torch.zeros((), dtype=torch.int32, device=dev)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for i in range(BANDED_STEPS):
        if i == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
        miss = miss + state.modules["physics"].counters["sap_window_miss"]
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (BANDED_STEPS - WARM_FRAMES)
    phys = state.modules["physics"]
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    lowest = float(phys.pos[1][occ].min())
    _, n_ops = count_ops(lambda: step(state, DT))
    log(f"[7 banded] {BANDED_BOXES} boxes at {BANDED_CAPACITY} actor slots, window "
        f"{BANDED_WINDOW}, {BANDED_STEPS} "
        f"steps at W=1 in {wall:.2f} s ({ms:.3f} ms/step), {n_ops} torch ops/step, launches "
        f"{launches}: sap_window_miss summed {int(miss)}, finite {finite}, lowest box centre "
        f"{lowest:.4f} m, active contacts at the end {int(phys.counters['active_contacts'])}")
    if int(miss) or not finite or not lowest > BOX_LOWEST_MIN:
        raise AssertionError(f"banded block: miss {int(miss)}, finite {finite}, lowest {lowest}")

    engine, world = PS.box_block(BANDED_COMPARE_BOXES, BANDED_COMPARE_CAPACITY,
                                  neighbors=BANDED_WINDOW)
    step = engine.build_step(world, dev)
    cpu_step = engine.build_step(world, "cpu")
    gpu = world.device_state(dev)
    for _ in range(BANDED_COMPARE_AT):
        gpu = step(gpu, DT)
    cpu, errs = gpu.to("cpu"), {}
    for _ in range(3):
        gpu, cpu = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu)
        for f, atol in (("pos", BODY_POS_ATOL), ("rot", BODY_POS_ATOL), ("vel", BODY_VEL_ATOL),
                        ("angvel", BODY_VEL_ATOL)):
            k = "modules.physics." + f
            errs[f] = max(errs.get(f, 0.0), float(np.abs(got[k] - ref[k]).max()))
            if not errs[f] <= atol:
                raise AssertionError(f"banded {f}: card vs plain {errs[f]} > {atol}")
        certs = {c: (int(got[f"modules.physics.counters.{c}"]),
                     int(ref[f"modules.physics.counters.{c}"]))
                 for c in ("sap_window_miss", "active_contacts")}
        if any(a != b for a, b in certs.values()):
            raise AssertionError(f"banded counters differ, card vs CPU: {certs}")
    same_rank = float(np.mean(got["modules.physics.sap_rank"] == ref["modules.physics.sap_rank"]))
    log(f"[7 banded] {BANDED_COMPARE_BOXES} boxes, 3 steps from step {BANDED_COMPARE_AT}, card "
        f"vs the CPU: max abs err {({k: float(f'{v:.3g}') for k, v in errs.items()})}, counters "
        f"(card, CPU) {certs}, sweep ranks equal {same_rank:.4f}")
    return {"ms": ms, "ops": n_ops, "launches": launches, "miss": int(miss), "lowest": lowest}


# -- game content: the props, drive and terrain farms and the banded props level --


def layer_time(fn, reps: int = LAYER_REPS):
    """(ms a call of fn() with CUDA events, ms a call of the card's kernels
    by torch.profiler, or None where the profiler reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_time(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    return ms, (total / 1e3 / reps if total > 0 else None)


def _show_layers(layers):
    return "; ".join(f"{name} {ms:.4f} ms a call (device {'not measured' if dev is None else f'{dev:.4f} ms'})"
                     for name, (ms, dev) in layers.items())


def k2_on_state(pm, state, label):
    """K2 against its plain version on the contact set `state` gives, on
    the worlds where no body with an active contact moves at SANE_SPEED or
    above before or after the solve (a CCD body clamped short of a surface
    keeps its speed and hovers without a contact, as in the JAX package);
    then both timed (plain, kernel, kernel, plain) and K2's bound over the
    active slots. Returns the record for the kernels line."""
    import torch

    from lumixengine_tpu_torch.ops import solver as S

    prob = pm.solver_problem(state, DT)
    plain = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
    speed = torch.stack([t.abs().amax(dim=1) for t in (prob.vel, prob.angvel, *plain[:2])]
                        ).amax(dim=0)                                       # [W, NB]
    act = (prob.act != 0).to(torch.float32)
    touch = torch.zeros_like(speed).scatter_add_(1, prob.body_a.long(), act).scatter_add_(
        1, prob.body_b.long().clamp_min(0), act * (prob.body_b >= 0)) > 0
    sane = ~((speed >= SANE_SPEED) & touch).any(dim=1)
    sub = S.ContactProblem(**{k: v if k == "inv_mass" else v[sane].contiguous()
                              for k, v in prob.tensors().items()})
    err = max_err(S.solve_cuda(sub, ITERATIONS, POSITION_ITERATIONS),
                  S.solve_plain(sub, ITERATIONS, POSITION_ITERATIONS))
    k_ms, plain_ms = alternate(lambda: S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS),
                               lambda: S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS), 5)
    w_, _, nb = prob.vel.shape
    c = prob.act.shape[-1]
    n_act = int((prob.act != 0).sum())
    n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
    nbytes = S.k2_bytes(w_, nb, c, n_act)
    bound_ms, by = bound(nbytes, S.k2_flops(w_, nb, c, n_act, n_pair, ITERATIONS,
                                            POSITION_ITERATIONS))
    if not err <= S.K2_PLAIN_ATOL or int(sane.sum()) < 0.99 * w_:
        raise AssertionError(f"K2 on {label}: {err} vs plain, {int(sane.sum())} of {w_} worlds "
                             f"below {SANE_SPEED}")
    return {"W": w_, "NB": nb, "C": c, "active": n_act, "max_abs_err": err,
            "worlds_compared": int(sane.sum()), "ms": k_ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / k_ms}


def game_checks(kind, sc, state, trace, hits):
    """The scene's physical checks (models/physics_scenes.py: the JAX tests'
    bounds) on every world, raising on the first broken one; world 0 starts
    as built, the others perturbed (replicate_scene), where the props
    world's resting heights do not apply. Returns world 0's readings."""
    from lumixengine_tpu_torch.models import physics_scenes as PS

    ms = state.modules["physics"]
    pos, vel, ang = (getattr(ms, f).cpu().numpy() for f in ("pos", "vel", "angvel"))
    cpos, cgr = ms.ctrl_pos.cpu().numpy(), ms.ctrl_grounded.cpu().numpy()
    wpos = state.world.pos.cpu().numpy()
    st = sc.world.modules["physics"].statics()
    first = None
    for w in range(pos.shape[0]):
        if kind == "props":
            out = PS.check_props(sc, pos[w], vel[w], trace[:, w], resting=(w == 0))
        elif kind == "drive":
            out = PS.check_drive(sc, pos[w], ang[w], trace[:, w], cpos[w], cgr[w],
                                 float(wpos[w, 0, sc.world.slot(sc.ents["player"])]), int(hits[w]))
        else:
            out = PS.check_terrain(sc, pos[w], st.radius, cpos[w], cgr[w],
                                   wpos[w, :, sc.world.slot(sc.ents["walker"])])
        first = out if first is None else first
    return first


def game_layers(kind, sc, state):
    """The device time of the new layers on the scene's end state."""
    import torch

    from lumixengine_tpu_torch.ops import convex_ops as CV

    pm = sc.world.modules["physics"]
    st = pm.statics()
    ms = state.modules["physics"]
    d = st.on(ms.pos.device, pm.system)
    pos, rot = ms.pos, ms.rot
    layers = {}
    if len(st.conv_pair_a):
        layers["polytope SAT (convex pairs)"] = layer_time(lambda: CV.polytope_pair_contacts(
            pos, rot, d.poly_verts, d.poly_axes, d.poly_rad, d.conv_pair_a, d.conv_pair_b))
    if st.has_conv_gnd and len(st.conv_idx):
        layers["polytope ground"] = layer_time(lambda: CV.polytope_ground_contacts(
            pos, rot, d.conv_verts, d.conv_rad, d.conv_idx, pm.system.ground_y))
    if st.sdf_colliders:
        layers["SDF streams"] = layer_time(lambda: pm._sdf_streams(st, d, pos, rot))
    if st.has_ccd:
        moved = pos + ms.vel * DT
        layers["CCD clamp"] = layer_time(lambda: pm._ccd_clamp(st, d, pos, moved))
    if st.heightfield_terrain >= 0:
        layers["heightfield stream"] = layer_time(lambda: pm._ground_stream(st, d, pos, rot))
    if st.has_vehicles:
        dt = torch.tensor(DT, device=pos.device)
        layers["vehicles"] = layer_time(lambda: pm._update_vehicles(d, ms, pos, rot, ms.vel,
                                                                    ms.angvel, dt))
    if kind == "drive":
        from lumixengine_tpu_torch.models import physics_scenes as PS

        offs, dirs = (torch.as_tensor(a, device=pos.device) for a in PS.drive_rays())
        layers["queries (64 rays + 64 sweeps a world)"] = layer_time(
            lambda: PS.drive_queries(sc, state, offs, dirs))
    return layers


def compare_game(kind, sc, state, step):
    """3 frames from the first 4 worlds of `state` with the scene's host
    inputs, the card's step (K2) against the CPU's (plain), at
    BODY_POS_ATOL / BODY_VEL_ATOL (physics_scenes.state_gap), a body's
    sleep counter allowed to flip at the calm threshold. A frame that breaks
    them is explained from the CPU's state before it
    (physics_scenes.explain_break): the card's frame holds there (the
    devices' drift flipped a decision), or the card's and the CPU's contact
    sets differ only at ties or by rounding within CONTACT_TIE_ATOL (a hull
    rocking on coplanar contacts amplifies it) and the card's frame holds on
    the CPU's set. After a flip both go on from the CPU's state. On the
    banded branch the CPU's decisions are its polytope SAT grids. Returns
    (max abs errors, [(frame, cause and what broke, margin)])."""
    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import physics_banded as PBD

    pm = sc.world.modules["physics"]
    banded = pm.statics().banded
    own_sat = PBD.banded_polytope_grids

    def cpu_sat(*args):
        """The banded polytope SAT on the CPU, its grids on the card."""
        return tuple(x.to(dev) for x in own_sat(*(a.cpu() for a in args[:5]), *args[5:]))

    gpu = map_tensors(lambda t: t[:4].clone(), state)
    dev = gpu.local.pos.device
    cpu, cpu_step = gpu.to("cpu"), sc.engine.build_step(sc.world, "cpu")
    frame0 = int(state.frame.reshape(-1)[0])
    errs, flips = {}, []

    def gap(got, ref):
        return PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)[:2]

    for f in range(3):
        gpu = PS.scene_inputs(kind, sc, gpu, frame0 + f)
        cpu = PS.scene_inputs(kind, sc, cpu, frame0 + f)
        gnext, cnext = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gnext), bridge.state_to_numpy(cnext)
        out, broke, woke = PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)
        if broke is not None:
            drift = max(gap(bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu))[0].values())
            cause, margin, out = PS.explain_break(
                step, cpu.to(dev), ref, gap, drift, pm,
                None if banded else (lambda c=cpu: pm._contact_stage(c, DT).contacts),
                cpu_sat if banded else None)
            flips.append((frame0 + f + 1, f"{cause} ({broke})", float(f"{margin:.3g}")))
        if woke.any():
            flips.append((frame0 + f + 1, "sleep counters", int(woke.sum())))
        if broke is not None or woke.any():
            gnext = cnext.to(dev)
        for k, v in out.items():
            k = k.replace(PS.PH, "")
            errs[k] = max(errs.get(k, 0.0), v)
        gpu, cpu = gnext, cnext
    return {k: float(f"{v:.3g}") for k, v in errs.items() if v}, flips


def run_game(kind, dev, card):
    """One game-content farm (models/physics_scenes.py) at GAME_WORLDS[kind]
    worlds, the scene's frame count with its host inputs (the drive farm's
    64 rays and 64 sweeps a world a frame inside the timed frames), timed
    with CUDA events; its physical checks on every world; K2 on its end
    contact set against plain, timed and against its bound; torch ops a
    frame; the device time of the new layers; 3 frames card vs CPU."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S

    builder = {"props": PS.props_world, "drive": PS.drive_world, "terrain": PS.terrain_world}[kind]
    frames = {"props": PS.PROPS_FRAMES, "drive": PS.DRIVE_FRAMES,
              "terrain": PS.TERRAIN_FRAMES}[kind]
    num_worlds = GAME_WORLDS[kind]
    sc = builder()
    pm = sc.world.modules["physics"]
    st = pm.statics()
    step = sc.engine.build_step(sc.world, dev)
    state = PS.replicate_scene(PS.start_state(sc, dev), num_worlds, 12)
    offs, dirs = (torch.as_tensor(a, device=dev) for a in PS.drive_rays())
    trace_idx = torch.as_tensor(sc.trace, dtype=torch.int64, device=dev)
    trace = []
    hits = torch.zeros((2, num_worlds), dtype=torch.int64, device=dev)   # rays, sweeps

    def frame(state, f):
        state = step(PS.scene_inputs(kind, sc, state, f), DT)
        if kind == "drive":
            (hit, _t, _i), (shit, _st, _si) = PS.drive_queries(sc, state, offs, dirs)
            return state, torch.stack([hit.sum(dim=-1), shit.sum(dim=-1)])
        return state, None

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for f in range(frames):
        if f == WARM_FRAMES:
            ev0.record()
        state, h = frame(state, f)
        if len(sc.trace):
            trace.append(state.modules["physics"].pos.index_select(-1, trace_idx))
        if h is not None:
            hits += h
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (frames - WARM_FRAMES)
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    n_dyn = int(st.dyn_mask.sum())
    rate = num_worlds * n_dyn / (ms / 1e3)
    active = state.modules["physics"].counters["active_contacts"]
    tr = torch.stack(trace).cpu().numpy() if trace else None
    if not _launched(launches, 0, frames) or not finite:
        raise AssertionError(f"{kind} farm: launches {launches}, finite {finite}")
    first = game_checks(kind, sc, state, tr, hits[0].cpu().numpy())
    _, n_ops = count_ops(lambda: frame(state, frames))
    k2 = k2_on_state(pm, state, f"the {kind} farm")
    layers = game_layers(kind, sc, state)
    log(f"[7 {kind}] {card}: W={num_worlds}, {n_dyn} dynamic bodies a world (NB={st.nb}, "
        f"C={st.n_contact_slots}), {frames} frames in {wall:.2f} s: {ms:.3f} ms/frame = "
        f"{rate:.4g} body-steps/s, {n_ops} torch ops/frame, launches {launches}, finite "
        f"{finite}, active contacts {int(active.sum())} (worlds with contacts "
        f"{int((active > 0).sum())})" + (f", ray hits {int(hits[0].sum())}, sweep hits "
                                         f"{int(hits[1].sum())}" if kind == "drive" else ""))
    log(f"[7 {kind}] checks (the JAX tests' bounds) hold in all {num_worlds} worlds; world 0: "
        f"{first}")
    log(f"[7 {kind}] {card}: K2 on its contact set W={k2['W']} NB={k2['NB']} C={k2['C']} (active "
        f"{k2['active']}): {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, {k2['bytes']} bytes, "
        f"bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}), max abs err vs plain "
        f"{k2['max_abs_err']:.3e} (limit {S.K2_PLAIN_ATOL:g}; {k2['worlds_compared']} worlds)")
    log(f"[7 {kind}] {card}: new layers on the end state: {_show_layers(layers)}")
    errs, flips = compare_game(kind, sc, state, step)
    log(f"[7 {kind}] 3 frames at W=4, card vs plain on the CPU: max abs err {errs}; decisions "
        f"flipped (frame, cause and what broke, margin; or frame, 'sleep counters', bodies): "
        f"{flips}")
    return {"ms": ms, "rate": rate, "ops": n_ops, "launches": launches, "k2": k2,
            "layers": layers, "worlds": num_worlds}


def _runs(xs):
    """Run-length text of a sequence: '0x360' or '0x120, 3, 0x239'."""
    out, i = [], 0
    while i < len(xs):
        j = i
        while j < len(xs) and xs[j] == xs[i]:
            j += 1
        out.append(f"{xs[i]}x{j - i}" if j - i > 1 else f"{xs[i]}")
        i = j
    return ", ".join(out)


def run_banded_props(dev, card):
    """The banded props level: BANDED_PROPS_HULLS random hulls over the SDF
    slab and the ground at as many actor slots (`auto` picks the banded
    branch), BANDED_PROPS_STEPS steps at W=1 (BANDED_PROPS_STEPS_CUT in the
    whole script) with the window certificate of every step, then the JAX
    pile test's bounds hull by hull (read at the cut depth, held at the full)
    (physics_scenes.check_banded_props: at most BANDED_PROPS_UNSETTLED
    hulls with a velocity component of 0.8 m/s or a vertex 2 cm deep in the
    ground or the slab), the device time of the banded polytope SAT and
    the SDF streams, and 3 steps card vs CPU on 4 of the level's stacks."""
    import torch

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import convex_ops as CV
    from lumixengine_tpu_torch.ops import physics_banded as PBD

    sc = PS.banded_props_level(hulls=BANDED_PROPS_HULLS, capacity=BANDED_PROPS_HULLS,
                               neighbors=PS.BANDED_PROPS_WINDOW)
    pm = sc.world.modules["physics"]
    st = pm.statics()
    if not st.sap:
        raise AssertionError("the banded props level did not take the banded branch")
    step = sc.engine.build_step(sc.world, dev)
    state = PS.start_state(sc, dev)
    n_steps = PS.BANDED_PROPS_STEPS if FULL_DEPTH else BANDED_PROPS_STEPS_CUT
    misses = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
        misses.append(state.modules["physics"].counters["sap_window_miss"])
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (n_steps - WARM_FRAMES)
    misses = torch.stack(misses).cpu().tolist()
    phys = state.modules["physics"]
    d = st.on(dev, pm.system)
    vw = CV.polytope_world_verts(phys.pos, phys.rot, d.poly_verts).cpu().numpy()
    slots = list(sc.slots.values())
    pen = PS.hull_penetration(vw[..., slots], st.poly_vert_valid[:, slots])
    pos, vel = phys.pos.cpu().numpy(), phys.vel.cpu().numpy()
    checks = PS.check_banded_props(sc, pos, vel, pen, unsettled_max=len(slots))   # the readings
    _, n_ops = count_ops(lambda: step(state, DT))
    # the banded SAT of one sweep order and the SDF streams, on the end state
    order = torch.argsort(phys.pos[0])
    K, k = pm.sap_neighbors, pm.points_per_pair

    def rk(x):
        return x.index_select(-1, order)

    layers = {"banded polytope SAT (one sweep)": layer_time(lambda: PBD.banded_polytope_grids(
        rk(phys.pos), rk(phys.rot), rk(d.poly_verts), rk(d.poly_axes), rk(d.poly_rad), K, k)),
        "SDF streams": layer_time(lambda: pm._sdf_streams(st, d, phys.pos, phys.rot))}
    log(f"[7 banded props] {card}: {BANDED_PROPS_HULLS} hulls at {st.nb} actor slots over the SDF "
        f"slab, window {PS.BANDED_PROPS_WINDOW}, {n_steps} steps at W=1 in {wall:.2f} s "
        f"({ms:.3f} ms/step = {BANDED_PROPS_HULLS / (ms / 1e3):.4g} body-steps/s), {n_ops} torch "
        f"ops/step, launches {launches}; the JAX test's bounds hull by hull: {checks} (at most "
        f"{BANDED_PROPS_UNSETTLED} unsettled"
        + (")" if FULL_DEPTH else f" after {PS.BANDED_PROPS_STEPS} steps, held by "
           f"tools/sim_tier.py; here the readings at the cut depth)"))
    log(f"[7 banded props] window certificate (sap_window_miss) of each step: {_runs(misses)}; "
        f"summed {sum(misses)}")
    log(f"[7 banded props] {card}: {_show_layers(layers)}")
    if FULL_DEPTH:
        PS.check_banded_props(sc, pos, vel, pen, unsettled_max=BANDED_PROPS_UNSETTLED)
    if not _launched(launches, 0, 0):
        raise AssertionError(f"the banded branch launched {launches}")

    # the banded polytope SAT of the level's end state, one sweep order, on
    # the card against the CPU: equal but at ties (physics_scenes.contact_ties)
    grids = [PBD.banded_polytope_grids(*(rk(x).to(where) for x in (
        phys.pos, phys.rot, d.poly_verts, d.poly_axes, d.poly_rad)), K, k) for where in (dev, "cpu")]
    ties = PS.contact_ties(PS.grid_rows(grids[0]), PS.grid_rows(grids[1]))
    log(f"[7 banded props] the banded polytope SAT of the end state (one sweep, "
        f"{int(grids[1][3].sum())} active slots) on the card vs the CPU: equal but at "
        f"{len(ties)} ties (largest depth margin {max([m for *_x, m in ties] or [0.0]):.3g})")

    hulls, capacity, at = BANDED_PROPS_COMPARE
    sc = PS.banded_props_level(hulls=hulls, capacity=capacity, neighbors=PS.BANDED_PROPS_WINDOW)
    step, cpu_step = sc.engine.build_step(sc.world, dev), sc.engine.build_step(sc.world, "cpu")
    gpu = PS.start_state(sc, dev)
    for _ in range(at):
        gpu = step(gpu, DT)
    cpu, errs, flips = gpu.to("cpu"), {}, []
    own_sat = PBD.banded_polytope_grids

    def gap(got, ref):
        return PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL)[:2]

    def cpu_sat(*args):
        """The banded polytope SAT on the CPU, its grids on the card."""
        return tuple(x.to(dev) for x in own_sat(*(a.cpu() for a in args[:5]), *args[5:]))

    for i in range(3):
        gnext, cnext = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gnext), bridge.state_to_numpy(cnext)
        out, broke = gap(got, ref)
        if broke is not None:
            # from the CPU's own state: the devices' drift flipped a decision,
            # or the card's banded SAT differs from the CPU's only at ties
            drift = max(gap(bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu))[0].values())
            cause, margin, out = PS.explain_break(step, cpu.to(dev), ref, gap, drift,
                                                  ref_sat=cpu_sat)
            flips.append((at + i + 1, f"{cause} ({broke})", float(f"{margin:.3g}")))
            gnext = cnext.to(dev)
        for k, v in out.items():
            k = k.replace(PS.PH, "")
            errs[k] = max(errs.get(k, 0.0), v)
        gpu, cpu = gnext, cnext
    log(f"[7 banded props] {hulls} hulls in stacks at {capacity} slots, 3 steps from step {at}, "
        f"card vs the CPU: max abs err {({k: float(f'{v:.3g}') for k, v in errs.items() if v})}; "
        f"decisions flipped (step, cause and what broke, margin): {flips}")
    return {"ms": ms, "ops": n_ops, "launches": launches, "miss": sum(misses), "checks": checks,
            "layers": layers}


# -- 10. the simulation tier: broadphase="sap", the stand-alone steps, the batched banded
# branch, the layered crowd --


def _pile_gpu_vs_cpu(step, state, carry, dev):
    """3 steps of a stand-alone world step on the card and on the CPU from
    `state` (pos, rot, vel, angvel on the card) tiled to 2 worlds, the
    second's positions moved by 0.1 mm: within BODY_POS_ATOL / BODY_VEL_ATOL
    with equal counters; a step that breaks them must hold them on the card
    from the CPU's state (the runs' drift flipped a decision). Returns
    (max abs errors, steps so held)."""
    import torch

    def tile(x, noise=False):
        x2 = torch.stack([x, x])
        if noise:
            x2[1] = x2[1] + 1e-4 * torch.randn(x.shape, generator=torch.Generator(
                device=x.device).manual_seed(5), device=x.device)
        return x2

    gpu = [tile(x, i == 0) for i, x in enumerate(state)]
    gc = None if carry is None else tuple(tile(x) for x in carry)
    cpu = [x.cpu() for x in gpu]
    cc = None if gc is None else tuple(x.cpu() for x in gc)
    errs, held = {"pos": 0.0, "vel": 0.0}, []

    def one(st, c):
        dt = torch.tensor(DT, dtype=torch.float32, device=st[0].device)
        out = step(*st, dt) if c is None else step(*st, dt, c)
        return list(out[:4]), out[4], (None if c is None else out[5])

    def gap(a, b, ca, cb):
        e = {"pos": max(float((x.cpu() - y).abs().max()) for x, y in zip(a[:2], b[:2])),
             "vel": max(float((x.cpu() - y).abs().max()) for x, y in zip(a[2:], b[2:]))}
        same = all(torch.equal(ca[k].cpu(), cb[k]) for k in ca)
        return e, same and e["pos"] <= BODY_POS_ATOL and e["vel"] <= BODY_VEL_ATOL

    for i in range(3):
        (g2, gcnt, gc2), (c2, ccnt, cc2) = one(gpu, gc), one(cpu, cc)
        e, ok = gap(g2, c2, gcnt, ccnt)
        if not ok:
            g3, g3cnt, _ = one([x.to(dev) for x in cpu],
                               None if cc is None else tuple(x.to(dev) for x in cc))
            e, ok = gap(g3, c2, g3cnt, ccnt)
            if not ok:
                raise AssertionError(f"stand-alone step, card vs CPU from the CPU's state: {e}")
            held.append(i + 1)
            g2 = [x.to(dev) for x in c2]
            gc2 = None if cc2 is None else tuple(x.to(dev) for x in cc2)
        errs = {k: max(errs[k], v) for k, v in e.items()}
        gpu, gc, cpu, cc = g2, gc2, c2, cc2
    return {k: float(f"{v:.3g}") for k, v in errs.items()}, held


def run_sap_pile(dev, card):
    """broadphase="sap" on the sap pile (physics_scenes.mixed_pile: 2,048
    boxes, spheres and capsules a world, window 32) at SAP_WORLDS diverging
    worlds for SAP_STEPS steps: ms/step, body-steps/s, torch ops a step, the
    window miss summed on the card (0), the JAX test's settle gates on every
    world (physics_scenes.check_pile, settled); no kernel launches (the branch
    bypasses K2, as the reference's). Then 3 frames card vs CPU on 4 of its
    worlds (compare_game)."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS

    sc = PS.mixed_pile(actors=PS.SAP_PILE_ACTORS, broadphase="sap", neighbors=32)
    st = sc.world.modules["physics"].statics()
    if not (st.sap and not st.banded):
        raise AssertionError("the sap pile did not take the sap branch")
    step = sc.engine.build_step(sc.world, dev)
    state = PS.replicate_scene(sc.world.device_state(dev), SAP_WORLDS, seed=6)
    miss = torch.zeros(SAP_WORLDS, dtype=torch.int32, device=dev)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for i in range(SAP_STEPS):
        if i == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
        miss = miss + state.modules["physics"].counters["sap_window_miss"]
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (SAP_STEPS - WARM_FRAMES)
    _, n_ops = count_ops(lambda: step(state, DT))
    ph = state.modules["physics"]
    gates = PS.check_pile(ph.pos.cpu().numpy(), ph.vel.cpu().numpy(), ph.angvel.cpu().numpy(),
                          st.occupied, PS.rest_heights(st.shape, st.radius, st.half_extents),
                          settled=True)
    rate = SAP_WORLDS * PS.SAP_PILE_ACTORS / (ms / 1e3)
    ev_ms, dev_ms = layer_time(lambda: step(state, DT), 3)
    busy = "not measured" if dev_ms is None else f"{dev_ms / ev_ms:.4f}"
    log(f"[10 sap] {card}: the sap pile, {PS.SAP_PILE_ACTORS} actors a world at W={SAP_WORLDS}, "
        f"{SAP_STEPS} steps in {wall:.2f} s: {ms:.3f} ms/step = {rate:.4g} body-steps/s, {n_ops} "
        f"torch ops/step, launches {launches}, sap_window_miss summed {int(miss.sum())}, active "
        f"contacts at the end {int(ph.counters['active_contacts'].sum())}; gates {gates}; one "
        f"step {ev_ms:.4f} ms on events, {dev_ms} ms of kernels (torch.profiler): device-busy "
        f"share {busy}")
    if int(miss.sum()) or not _launched(launches, 0, 0):
        raise AssertionError(f"sap pile: miss {int(miss.sum())}, launches {launches}")
    errs, flips = compare_game("sap", sc, state, step)
    log(f"[10 sap] 3 frames at W=4 card vs CPU: max abs err {errs}; decisions flipped {flips}")
    return {"ms": ms, "rate": rate, "ops": n_ops, "launches": launches, "miss": int(miss.sum())}


def run_pile_steps(dev, card):
    """The stand-alone steps on the elongated pile (physics_scenes.elongated_pile
    at PILE_BOXES boxes): make_big_world_step and make_banded_world_step
    (4 sweeps, warm start) at test_box_drop_statistics's settings for
    PILE_FALL_STEPS + PILE_SETTLE_STEPS steps (PILE_SETTLE_STEPS_CUT settle
    steps in the whole script), each step's window certificate summed on
    the card, that test's gates (physics_scenes.check_box_drop; the free-fall
    gate alone at the cut depth), exact_window_miss on the banded end state
    (0); then make_banded_world_step on box_drop_pile(10_000) at
    window BANDED_WINDOW for BANDED10K_STEPS steps, its certificate and
    exact_window_miss (both 0). Each: ms/step, body-steps/s, torch ops a
    step; 3 steps card vs CPU at W=2 on the pile at PILE_COMPARE_BOXES boxes
    from its step PILE_COMPARE_AT."""
    import torch

    from lumixengine_tpu_torch.models import demo_scenes as DS
    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import physics_banded as PBD
    from lumixengine_tpu_torch.ops import physics_big as PBG
    from lumixengine_tpu_torch.ops import physics_ops as P

    out = {}

    def exact_miss(pos, rot, tables, K):
        nb = pos.shape[-1]
        t = [torch.as_tensor(x, device=dev) for x in tables[:3]]
        mn, mx = P.world_aabb(pos, rot, t[0].long(), t[1], t[2])
        occ = torch.ones(nb, dtype=torch.bool, device=dev)
        _o, ranks, _c = PBD.sweep_orders(mn, mx, occ, 4)
        return int(PBD.exact_window_miss(mn, mx, occ, occ, ranks, K, min_overlap=0.005))

    dt = torch.tensor(DT, dtype=torch.float32, device=dev)

    def run(name, step, state, carry, steps, nb, fall=None):
        miss = torch.zeros((), dtype=torch.int32, device=dev)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        _zero_launches()
        t0, vx_fall = time.perf_counter(), None
        for i in range(steps):
            if i == WARM_FRAMES:
                ev0.record()
            res = step(*state, dt) if carry is None else step(*state, dt, carry)
            state, carry = list(res[:4]), (None if carry is None else res[5])
            miss = miss + res[4]["sap_window_miss"]
            if fall is not None and i + 1 == fall:
                vx_fall = state[2][0].clone()
        ev1.record()
        torch.cuda.synchronize()
        wall, launches = time.perf_counter() - t0, _launches()
        ms = ev0.elapsed_time(ev1) / (steps - WARM_FRAMES)
        st1, ca1 = state, carry
        _, n_ops = count_ops(lambda: step(*st1, dt) if ca1 is None else step(*st1, dt, ca1))
        finite = all(bool(torch.isfinite(x).all()) for x in state)
        r = {"ms": ms, "rate": nb / (ms / 1e3), "ops": n_ops, "miss": int(miss),
             "launches": launches, "finite": finite, "wall": wall}
        if int(miss) or not finite or not _launched(launches, 0, 0):
            raise AssertionError(f"{name}: {r}")
        return state, carry, vx_fall, r

    def make(kind, nb):
        tables = PS.box_pile_tables(nb)
        if kind == "dynamic":
            return PBG.make_big_world_step(*tables, **PS.PILE_STEP), None
        step = PBD.make_banded_world_step(*tables, **PS.PILE_STEP, n_sweeps=4, warm_start=True)
        return step, step.init_carry(dev)

    def pile(nb):
        pos0, rot0 = PS.elongated_pile(nb)
        z = torch.zeros((3, nb), device=dev)
        return [torch.as_tensor(pos0, device=dev), torch.as_tensor(rot0, device=dev), z, z]

    nb = PILE_BOXES
    tables = PS.box_pile_tables(nb)
    settle = PS.PILE_SETTLE_STEPS if FULL_DEPTH else PILE_SETTLE_STEPS_CUT
    for kind in ("dynamic", "banded"):
        step, carry = make(kind, nb)
        state, carry, vx_fall, r = run(kind, step, pile(nb), carry, PS.PILE_FALL_STEPS + settle,
                                       nb, fall=PS.PILE_FALL_STEPS)
        if FULL_DEPTH:
            r["gates"] = PS.check_box_drop(kind, vx_fall.cpu().numpy(), state[0].cpu().numpy(),
                                           state[2].cpu().numpy(), state[3].cpu().numpy(),
                                           r["miss"])
        else:
            # the settle gates need the full count (tools/sim_tier.py): the fall gate here
            y = state[0][1]
            r["gates"] = {"vx_sum_fall": float(vx_fall.sum().abs()), "lowest": float(y.min()),
                          "highest": float(y.max()), "miss": r["miss"],
                          "settle gates": f"after {PS.PILE_SETTLE_STEPS} settle steps, "
                                          "tools/sim_tier.py"}
            if not r["gates"]["vx_sum_fall"] < PS.PILE_VX_SUM_MAX:
                raise AssertionError(f"{kind} pile, free fall: {r['gates']}")
        if kind == "banded":
            r["exact_window_miss"] = exact_miss(state[0], state[1], tables,
                                                PS.PILE_STEP["neighbors"])
            if r["exact_window_miss"]:
                raise AssertionError(f"banded pile: exact_window_miss {r['exact_window_miss']}")
        step, carry = make(kind, PILE_COMPARE_BOXES)
        cmp, carry, _vx, _r = run(kind, step, pile(PILE_COMPARE_BOXES), carry, PILE_COMPARE_AT,
                                  PILE_COMPARE_BOXES)
        r["gpu_vs_cpu"], r["held"] = _pile_gpu_vs_cpu(step, cmp, carry, dev)
        log(f"[10 pile] {card}: make_{'big' if kind == 'dynamic' else 'banded'}_world_step, "
            f"{nb} boxes, window {PS.PILE_STEP['neighbors']}, "
            f"{PS.PILE_FALL_STEPS + settle} steps in {r['wall']:.2f} s: "
            f"{r['ms']:.3f} ms/step = {r['rate']:.4g} body-steps/s, {r['ops']} torch ops/step, "
            f"launches {r['launches']}, certificate summed {r['miss']}"
            + (f", exact_window_miss {r['exact_window_miss']}" if kind == "banded" else "")
            + f"; gates {r['gates']}; the pile at {PILE_COMPARE_BOXES} boxes, 3 steps from step "
            f"{PILE_COMPARE_AT} at W=2, card vs CPU: max abs err {r['gpu_vs_cpu']}, steps held "
            f"from the CPU's state {r['held']}")
        out[kind] = r

    nb = BANDED10K_BOXES
    tables = PS.box_pile_tables(nb)
    _slot_step, pile, _consts = DS.box_drop_pile(nb, device=dev)
    del _slot_step, _consts
    step = PBD.make_banded_world_step(*tables, neighbors=BANDED_WINDOW, n_sweeps=4,
                                      warm_start=True)
    state = [pile[0], pile[1], torch.zeros_like(pile[2]), torch.zeros_like(pile[3])]
    state, _carry, _vx, r = run("banded 10k", step, state, step.init_carry(dev),
                                BANDED10K_STEPS, nb)
    r["exact_window_miss"] = exact_miss(state[0], state[1], tables, BANDED_WINDOW)
    r["lowest"] = float(state[0][1].min())
    log(f"[10 pile] {card}: make_banded_world_step on box_drop_pile({nb}), window "
        f"{BANDED_WINDOW}, 4 sweeps, warm start, {BANDED10K_STEPS} steps in {r['wall']:.2f} s: "
        f"{r['ms']:.3f} ms/step = {r['rate']:.4g} body-steps/s, {r['ops']} torch ops/step, "
        f"launches {r['launches']}, certificate summed {r['miss']}, exact_window_miss "
        f"{r['exact_window_miss']}, lowest centre {r['lowest']:.4f} m")
    if r["exact_window_miss"] or not r["lowest"] > BOX_LOWEST_MIN:
        raise AssertionError(f"banded 10k: {r}")
    out["banded_10k"] = r
    return out


def run_banded_farm(dev, card):
    """The banded branch batched over worlds: the banded farm
    (physics_scenes.mixed_pile at BANDED_FARM_ACTORS actors, which `auto`
    takes to the banded branch) at each width of FARM_WIDTHS for
    BANDED_FARM_STEPS steps (BANDED_FARM_STEPS_CUT in the whole script): ms/step, body-steps/s, torch ops a step (equal
    within 2% across the widths: one pass over the batch), the window
    certificate summed (0), the blow-up gates on every world (the piles are
    still landing at BANDED_FARM_STEPS: physics_scenes.check_pile, not
    settled); then 3 frames
    card vs CPU on 4 worlds of the widest."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS

    sc = PS.mixed_pile(actors=PS.BANDED_FARM_ACTORS, broadphase="auto", neighbors=32)
    st = sc.world.modules["physics"].statics()
    if not st.banded:
        raise AssertionError("the banded farm did not take the banded branch")
    step = sc.engine.build_step(sc.world, dev)
    out = {}
    n_steps = BANDED_FARM_STEPS if FULL_DEPTH else BANDED_FARM_STEPS_CUT
    for w in FARM_WIDTHS:
        state = PS.replicate_scene(sc.world.device_state(dev), w, seed=8)
        miss = torch.zeros(w, dtype=torch.int32, device=dev)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        for i in range(n_steps):
            if i == WARM_FRAMES:
                ev0.record()
            state = step(state, DT)
            miss = miss + state.modules["physics"].counters["sap_window_miss"]
        ev1.record()
        torch.cuda.synchronize()
        wall, launches = time.perf_counter() - t0, _launches()
        ms = ev0.elapsed_time(ev1) / (n_steps - WARM_FRAMES)
        _, n_ops = count_ops(lambda: step(state, DT))
        ph = state.modules["physics"]
        gates = PS.check_pile(ph.pos.cpu().numpy(), ph.vel.cpu().numpy(),
                              ph.angvel.cpu().numpy(), st.occupied,
                              PS.rest_heights(st.shape, st.radius, st.half_extents), settled=False)
        r = {"ms": ms, "rate": w * PS.BANDED_FARM_ACTORS / (ms / 1e3), "ops": n_ops,
             "miss": int(miss.sum()), "launches": launches}
        log(f"[10 farm] {card}: the banded farm, {PS.BANDED_FARM_ACTORS} actors a world at W={w}, "
            f"{n_steps} steps in {wall:.2f} s: {ms:.3f} ms/step = {r['rate']:.4g} "
            f"body-steps/s, {n_ops} torch ops/step, launches {launches}, certificate summed "
            f"{r['miss']}, active contacts at the end {int(ph.counters['active_contacts'].sum())}; "
            f"gates {gates}")
        if r["miss"] or not _launched(launches, 0, 0):
            raise AssertionError(f"banded farm at W={w}: {r}")
        out[w] = r
    ops = [out[w]["ops"] for w in FARM_WIDTHS]
    spread = (max(ops) - min(ops)) / min(ops)
    log(f"[10 farm] torch ops a step at W={list(FARM_WIDTHS)}: {ops} (spread {spread:.4f})")
    if spread > 0.02:
        raise AssertionError(f"the banded farm's ops grow with the worlds: {ops}")
    errs, flips = compare_game("farm", sc, state, step)
    log(f"[10 farm] 3 frames at W=4 card vs CPU: max abs err {errs}; decisions flipped {flips}")
    return out


def run_layered(dev, card, replicate_state, map_tensors):
    """The layered crowd (demo_scenes.layered_crowd_world: Layers over a
    Blend2D base, a Switch over a Select on the upper body, an IKNode arm,
    8 point lights and a platform under property animators) with
    LAYERED_CHARACTERS animators a world at LAYERED_WORLDS worlds through
    Engine.build_step(extra=cull_pass) for LAYERED_FRAMES frames: ms/frame,
    entity-steps/s, torch ops a frame; K1 once a frame and bit for bit to
    its plain version on the path's operands; every reachable effector
    within IK_REACH_ATOL of its target on every world; every animated row
    np.interp of its curve at the frame's time within PROPERTY_ATOL; 3
    frames card vs CPU at W=4 (the animated rows within PROPERTY_ATOL)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.models import demo_scenes as DS

    engine, world, h = DS.layered_crowd_world(LAYERED_CHARACTERS)
    rm = world.modules["renderer"]
    step = engine.build_step(world, dev, extra=rm.cull_pass)
    state = replicate_state(world.device_state(dev), LAYERED_WORLDS,
                            torch.Generator(device=dev).manual_seed(9))
    state, ms, wall, launches = _timed_frames(step, state, LAYERED_FRAMES - 1, WARM_FRAMES)
    t_read = state.time.cpu().numpy()
    state = step(state, DT)
    launches = _launches()
    if not _launched(launches, LAYERED_FRAMES, 0):
        raise AssertionError(f"layered crowd launches {launches}")
    dist, reachable = DS.ik_gaps(world, state, h)
    ik_worst = float(dist[reachable].max())
    prop_worst = 0.0
    for _name, rows, want in DS.property_rows(world, state, float(t_read.reshape(-1)[0]), h):
        prop_worst = max(prop_worst, float(np.abs(rows - want).max()))
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    rate = LAYERED_WORLDS * world.capacity / (ms / 1e3)
    log(f"[10 layered] {card}: the layered crowd, {LAYERED_CHARACTERS} animators a world at "
        f"W={LAYERED_WORLDS}, {LAYERED_FRAMES} frames in {wall:.2f} s: {ms:.3f} ms/frame = "
        f"{rate:.4g} entity-steps/s, launches {launches}, finite {finite}; IK: effector to target "
        f"at most {ik_worst:.4f} m over the {int(reachable.sum())} reachable of {reachable.size} "
        f"(limit {DS.IK_REACH_ATOL}); property rows vs np.interp at most {prop_worst:.3g} "
        f"(limit {DS.PROPERTY_ATOL})")
    if not finite or not ik_worst < DS.IK_REACH_ATOL or not prop_worst <= DS.PROPERTY_ATOL:
        raise AssertionError(f"layered crowd: IK {ik_worst}, properties {prop_worst}")
    k1 = k1_on_path("layered", world, state)
    ops = op_counts(world, state, dev)
    log(f"[10 layered] torch ops dispatched in one frame: {sum(ops.values())} = {ops}")
    cmp = compare_with_plain(engine, world, map_tensors(lambda t: t[:4].clone(), state), step,
                             extra=(("modules.renderer.pl_intensity", DS.PROPERTY_ATOL),
                                    ("modules.renderer.pl_range", DS.PROPERTY_ATOL)))
    log(f"[10 layered] 3 frames at W=4, card vs plain on the CPU: max abs err {cmp['errs']}, "
        f"boundary flips {cmp['flips']}")
    return {"ms": ms, "rate": rate, "ops": sum(ops.values()), "launches": launches, "k1": k1,
            "ik_worst": ik_worst, "prop_worst": prop_worst}


def run_sim_tier(dev, card, replicate_state, map_tensors):
    """Phase 10: the sap pile, the stand-alone steps, the banded farm and the
    layered crowd, each with the launch counts set to 0 just before it and
    read just after."""
    return {"sap": run_sap_pile(dev, card), "piles": run_pile_steps(dev, card),
            "farm": run_banded_farm(dev, card),
            "layered": run_layered(dev, card, replicate_state, map_tensors)}


def _to_cpu(tree):
    if isinstance(tree, tuple):
        return tuple(_to_cpu(t) for t in tree)
    return tree.cpu()


def count_ops(fn):
    """(fn(), the number of non-view torch ops it dispatched). Each is about
    one kernel launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        out = fn()
    return out, c.n


def op_counts(world, state, dev, passes=False):
    """The torch ops one frame dispatches, per module phase, counted on the
    host as the phases of Engine.build_step run on `state` (and with
    `passes`, the render config's shadow and cluster passes)."""
    import torch

    from lumixengine_tpu_torch.ops import hierarchy as hier
    from lumixengine_tpu_torch.renderer import clusters, shadows

    counts = {}
    dt = torch.tensor(DT, dtype=torch.float32, device=dev)

    def run(key, fn):
        out, n = count_ops(fn)
        if n:
            counts[key] = counts.get(key, 0) + n
        return out

    rm = world.modules["renderer"]
    for phase in ("end_frame", "update_parallel", "update", "late_update"):
        for m in world.modules.values():
            state = run(f"{m.name}.{phase}", lambda: getattr(m, phase)(state, dt))
    state = run("hierarchy", lambda: state.replace(
        world=hier.propagate_plan(state.local, world.plan)))
    state = run("renderer.cull_pass", lambda: rm.cull_pass(state, dt))
    if passes:
        run("shadow_pass", lambda: shadows.shadow_pass(state, rm, LIGHT_DIR))
        run("fill_clusters", lambda: clusters.fill_clusters(state, rm))
    return counts


def _root_motion(world, start, state):
    """(min, max) distance the animators' entities moved, and whether every
    animator whose speed input is above 0.5 moved more than 0.1 m."""
    import torch

    an = world.modules["animation"]
    if not len(an.animators):
        return 0.0, 0.0, True
    slots = [world.slot(int(e)) for e in an.animators.entity if e >= 0]
    cols = [c for c in range(an.animators.capacity) if an.animators.entity[c] >= 0]
    speed = torch.as_tensor(an.default_inputs[0, cols])
    d = (state.local.pos[..., :, slots] - start.local.pos[..., :, slots]).norm(dim=-2).cpu()
    fast = speed > 0.5
    return float(d.min()), float(d.max()), bool((d[:, fast] > 0.1).all())


def _float_tensors(state):
    from lumixengine_tpu_torch.engine.world import map_tensors

    out = []
    map_tensors(lambda t: out.append(t) if t.is_floating_point() else None, state)
    return out


def _storm_kill_margin(channels, dt):
    """How far each storm particle's next update sits from its kill
    thresholds (pos.y < 0, t > 6), from its channels [.., 7, cap]."""
    import numpy as np

    y = channels[..., 1, :] + (channels[..., 4, :] - STORM_G * dt) * dt
    t = channels[..., 6, :] + dt
    return np.minimum(np.abs(y), np.abs(t - 6.0))


def compare_with_plain(engine, world, state, step, views=False, extra=()):
    """3 frames from the same W=4 state: the card's step (kernels) against the
    CPU step (plain versions), at the CPU parity tests' tolerances; with
    `views`, each frame's prepare_view (both sort modes), shadow and cluster
    passes too; `extra` is (field name prefix, atol) pairs: those fields'
    floats within atol, the rest of them equal. Returns the errors, the
    flips and the card's end state."""
    import numpy as np

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.renderer import pipeline

    rm = world.modules["renderer"]
    an = world.modules.get("animation")
    cpu_step = engine.build_step(world, "cpu", extra=rm.cull_pass)
    body = np.zeros(world.capacity, bool)
    if "physics" in world.modules:
        pst = world.modules["physics"].statics()
        body[pst.entity_slots[pst.dyn_mask]] = True
    mi_body = body[rm.statics().mi_slots.clip(0)]
    char = np.zeros(world.capacity, bool)
    for store in (an.animables, an.animators) if an is not None else ():
        char[world.to_slots(store.entity[store.entity >= 0])] = True
    gpu, cpu = state, state.to("cpu")
    errs, flips, kills, view_flips = {}, [], [], []
    diverged = {}  # emitter -> slots whose kill flipped (they differ from then on)

    def close(name, a, b, atol):
        err = float(np.abs(a - b).max(initial=0.0))
        errs[name] = max(errs.get(name, 0.0), err)
        if not err <= atol:
            raise AssertionError(f"{name}: card vs plain {err} > {atol}")

    for _ in range(3):
        prev = bridge.state_to_numpy(cpu)
        gpu, cpu = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu)
        for xf in ("local", "world"):
            for f in ("pos", "rot", "scale"):
                k = f"{xf}.{f}"
                close(k, got[k][..., ~body], ref[k][..., ~body], TRANSFORM_ATOL)
                close(k + "[bodies]", got[k][..., body], ref[k][..., body], BODY_POS_ATOL)
                close(k + "[characters]", got[k][..., char], ref[k][..., char], TRANSFORM_ATOL)
        for f in ("prev_pos", "prev_rot"):
            k = "modules.renderer." + f
            close(k, got[k][..., ~mi_body], ref[k][..., ~mi_body], TRANSFORM_ATOL)
            close(k + "[bodies]", got[k][..., mi_body], ref[k][..., mi_body], BODY_POS_ATOL)
        tolerances = [(("pos", "rot"), "physics", BODY_POS_ATOL),
                      (("vel", "angvel", "lam_n", "lam_t1", "lam_t2"), "physics", BODY_VEL_ATOL),
                      (("an_time", "ctrl_clocks"), "animation", CLOCK_ATOL),
                      (("pose_pos", "pose_rot", "palette"), "animation", POSE_ATOL)]
        for fields, module, atol in tolerances:
            for f in fields if module in world.modules else ():
                k = f"modules.{module}.{f}"
                close(f"{module}.{f}", got[k], ref[k], atol)
        for k in ("modules.physics.sleep", "modules.physics.pair_key", "frame",
                  "modules.animation.counters.animated", "modules.renderer.prng"):
            if k in ref and not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"{k}: card and plain differ")
        for prefix, atol in extra:
            for k in (n for n in ref if n.startswith(prefix)):
                if ref[k].dtype.kind == "f":
                    close(k.replace("modules.", ""), got[k], ref[k], atol)
                elif not np.array_equal(got[k], ref[k]):
                    raise AssertionError(f"{k}: card and plain differ")
        kills.append(_compare_particles(prev, got, ref, close, diverged))
        margins = [m.numpy() for m in pipeline.cull_margins(cpu, rm)]
        frame_flips = 0
        for name, m in zip(("mi_visible", "mi_lod", "pl_visible"), margins):
            k = "modules.renderer." + name
            off = got[k] != ref[k]
            if np.any(off & (np.abs(m) >= MARGIN)):
                raise AssertionError(f"{k}: card and plain differ away from the boundary")
            frame_flips += int(off.sum())
        for counter, mask in (("visible_count", "mi_visible"), ("lights_visible", "pl_visible")):
            c = got["modules.renderer.counters." + counter]
            if not np.array_equal(c, got["modules.renderer." + mask].sum(-1)):
                raise AssertionError(f"{counter} disagrees with its mask")
        flips.append(frame_flips)
        if views:
            view_flips.append(compare_views(rm, gpu, cpu, margins, close))
    return {"errs": {k: float(f"{v:.3g}") for k, v in errs.items() if v}, "flips": flips,
            "kills": kills, "view_flips": view_flips, "state": gpu}


def compare_views(rm, gpu, cpu, margins, close):
    """prepare_view in both sort modes, shadow_pass and fill_clusters of
    the card's state against the CPU's: the visible and LOD masks equal
    outside the cull margins, the keys equal away from every margin and
    the depth rounding, the draw order and instance buffers equal in the
    worlds whose keys all agree; cascade geometry within 1e-5 of its
    largest magnitude, casters equal outside shadows.SHADOW_MARGIN; cluster
    words equal outside clusters.CLUSTER_D2_EPS, lists and counts equal in
    the clusters with no flipped test, overflow off by at most the flips.
    Returns the flips (instances at a margin, casters, cluster tests)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.renderer import clusters, pipeline, shadows

    vis_m, lod_m, _light_m = margins
    depth_near = (pipeline.depth_margins(cpu, rm) < pipeline.DEPTH_EPS).numpy()
    out = {"view": 0}
    for mode in (pipeline.SORT_MATERIAL, pipeline.SORT_DEPTH):
        g = pipeline.prepare_view(gpu, rm, sort_mode=mode)
        c = pipeline.prepare_view(cpu, rm, sort_mode=mode)
        moved = g.visible.cpu().numpy() != c.visible.numpy()
        lod_off = g.lod.cpu().numpy() != c.lod.numpy()
        if np.any(moved & (np.abs(vis_m) >= MARGIN)) or np.any(lod_off & (np.abs(lod_m) >= MARGIN)):
            raise AssertionError(f"prepare_view {mode}: a mask differs away from its margin")
        moved |= lod_off | depth_near
        off = ((g.sort_key.cpu() != c.sort_key) | (g.sort_key_lo.cpu() != c.sort_key_lo)).numpy()
        if np.any(off & ~moved):
            raise AssertionError(f"prepare_view {mode}: a key differs away from every margin")
        same = torch.as_tensor(~off.any(-1))
        for f in ("order", "instance_model", "instance_slot", "visible_count"):
            if not torch.equal(getattr(g, f).cpu()[same], getattr(c, f)[same]):
                raise AssertionError(f"prepare_view {mode}: {f} differs in a world whose keys agree")
        for f in ("instance_pos", "instance_rot", "instance_scale"):
            close(f"view.{f}", getattr(g, f).cpu()[same].numpy(), getattr(c, f)[same].numpy(),
                  TRANSFORM_ATOL)
        out["view"] += int(off.sum())

    sg = shadows.shadow_pass(gpu, rm, LIGHT_DIR)
    sc = shadows.shadow_pass(cpu, rm, LIGHT_DIR)
    for f in ("splits", "center", "radius", "light_pos", "extent"):
        ref = getattr(sc, f).numpy()
        close(f"shadow.{f}", getattr(sg, f).cpu().numpy(), ref, 1e-5 * np.abs(ref).max())
    off = (sg.casters.cpu() != sc.casters).numpy()
    near = (shadows.caster_margins(cpu, rm, sc, LIGHT_DIR).abs() < shadows.SHADOW_MARGIN).numpy()
    counts = np.abs(sg.caster_count.cpu().numpy().astype(np.int64) - sc.caster_count.numpy())
    if np.any(off & ~near) or np.any(counts > off.sum(-1)):
        raise AssertionError("shadow casters differ away from a cascade plane")
    out["casters"] = int(off.sum())

    ig, ic = clusters.cluster_inputs(gpu, rm), clusters.cluster_inputs(cpu, rm)
    wg, wc = clusters._touch_words(*ig).cpu(), clusters._touch_words(*ic)
    off = clusters.unpack_words(wg ^ wc).numpy()
    if np.any(off & (clusters.touch_margins(*ic).numpy() >= clusters.CLUSTER_D2_EPS)):
        raise AssertionError("cluster words differ away from a light's range")
    lg, lc = clusters.fill_clusters(gpu, rm), clusters.fill_clusters(cpu, rm)
    same = torch.as_tensor(~off.any(-1))
    if not (torch.equal(lg.lights.cpu()[same], lc.lights[same])
            and torch.equal(lg.count.cpu()[same], lc.count[same])
            and int((lg.overflow.cpu() - lc.overflow).abs().max()) <= int(off.sum())):
        raise AssertionError("cluster lists, counts or overflow differ, card vs CPU")
    if int(lc.count.sum()) == 0:
        raise AssertionError("the cluster compare holds no light")
    out["cluster_tests"] = int(off.sum())
    return out


def _compare_particles(prev, got, ref, close, diverged):
    """The storm emitters' fields, card vs CPU: equal alive masks and
    counters, channels within PARTICLE_ATOL, except at slots whose kill sat
    within KILL_MARGIN of a threshold (a flipped kill respawns the slot on
    one side, and it differs from then on; `diverged` keeps those slots, and
    the counters may differ by their number). Returns the flipped count."""
    import numpy as np

    pre = "modules.renderer.particles."
    for k in sorted(n for n in ref if n.startswith(pre) and n.endswith(".channels")):
        base = k[: -len(".channels")]
        near = _storm_kill_margin(prev[k], DT) < KILL_MARGIN
        off = np.zeros(near.shape, bool)
        for f in ("channels", "outs"):
            a, b = got[f"{base}.{f}"], ref[f"{base}.{f}"]
            off |= np.abs(a - b).max(axis=-2) > PARTICLE_ATOL
        old = diverged.get(base, np.zeros(near.shape, bool))
        if np.any(off & ~near & ~old):
            raise AssertionError(f"{base}: card vs plain differ away from a kill threshold")
        skip = diverged[base] = old | (off & near)
        for f in ("channels", "outs"):
            a, b = got[f"{base}.{f}"], ref[f"{base}.{f}"]
            keep = np.broadcast_to(~skip[..., None, :], a.shape)
            close(f"particles.{f}", a[keep], b[keep], PARTICLE_ATOL)
        a, b = got[base + ".alive"], ref[base + ".alive"]
        if np.any((a != b) & ~skip):
            raise AssertionError(f"{base}.alive: card and plain differ away from a threshold")
    flipped = int(sum(int(m.sum()) for m in diverged.values()))
    for base in {k.rsplit(".", 1)[0] for k in ref if k.startswith(pre)}:
        for f in ("emit_acc", "emitted", "killed", "overflow"):
            a, b = got[f"{base}.{f}"], ref[f"{base}.{f}"]
            if np.abs(a.astype(np.float64) - b).max(initial=0) > flipped:
                raise AssertionError(f"{base}.{f}: card {a} vs plain {b}")
    for c in ("particles_alive", "particles_emitted", "particles_killed"):
        k = "modules.renderer.counters." + c
        if np.abs(got[k].astype(np.int64) - ref[k]).max(initial=0) > flipped:
            raise AssertionError(f"{k}: card {got[k]} vs plain {ref[k]}")
    return flipped


if __name__ == "__main__":
    sys.exit(main())
