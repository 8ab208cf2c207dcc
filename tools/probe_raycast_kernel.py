#!/usr/bin/env python
"""Where kernel C's time goes: time it with parts of it switched off, at 1,
3 and 6 prims, and beside the kernel it replaced.

    python3 tools/probe_raycast_kernel.py         # on a machine with the card

Each variant is a scratch copy of ``csrc/raycast.cu`` (under git-ignored
``build/``) with a few lines patched, all built together and timed in one
process, so every number comes from one card. ``full`` is also timed over
the number of envs a block walks. The results of a patched
kernel are wrong by construction; only its time is read. Variants:

  full        the kernel as committed
  nostore     no stores of the image (every value is still computed)
  nobound     no bounding-sphere test before a box's slab test
  stagedstore a warp passes its 384 floats through shared memory so that
              each of its three store instructions writes 512 contiguous
              bytes (the committed kernel writes 48 contiguous bytes a
              thread); also with ``noprims``
  noprims     no prim loop (ground plane, shading and stores only)
  noprologue  no per-block records and no barrier (the pixel loop reads
              whatever shared memory holds)
  constdirs   constant ray directions instead of the rays read from memory
  fastrcp     approximate reciprocals in the box slab test
  nonormal    the nearest hit never takes its normal (the branch is skipped)
  minblocks2, minblocks4  ``__launch_bounds__`` asks for 2 or 4 resident
              blocks an SM (128 or 64 registers a thread at most; the
              committed kernel asks for 3)

Scene sets, 1024 envs at 64x64: ``lift3`` the kinematic Lift scenes (3
axis-aligned boxes), ``lift1`` their first prim alone, ``phys6`` the physics
Lift scenes (cube, two sphere pads, three rotated arm-link boxes) after a few
scripted steps. The time is the kernel's launch alone (arguments marshalled
once), over 50 launches between two CUDA events.

``previous`` is the kernel this one replaced, built from
``build/raycast_previous.cu`` (save it there with ``git show
<commit>:latent_diffusion_planning_tpu_torch/csrc/raycast.cu``; skipped with
a note when the file is missing). It is timed in turns with ``full``
(previous, full, full, previous), launch alone and with the packing its
wrapper did before each launch.

Prints one JSON line per measurement, each with the card's name and power
limit. ``--sass PATH`` also disassembles the committed kernel there
(``cuobjdump -sass``) and prints its instruction counts.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
N_ENVS, H, W = 1024, 64, 64
PREVIOUS = REPO / "build" / "raycast_previous.cu"

PATCHES = {
    "full": [],
    "nostore": [("    float* o = a.out + ",
                 "    float sum_ = 0.f;\n"
                 "    for (int i = 0; i < 3 * kPix; ++i) sum_ += rgb[i];\n"
                 "    if (sum_ != 12345.f) continue;\n"
                 "    float* o = a.out + ")],
    "nobound": [("        if (!maybe) continue;\n", "")],
    "stagedstore": [("    if (kVec) {\n      float4* o4 = reinterpret_cast<float4*>(o);\n",
                     "    if (kVec && a.HW % 128 == 0) {\n"
                     "      __shared__ float4 stage[kThreads * 3];\n"
                     "      const int lane = threadIdx.x & 31;\n"
                     "      float4* st = stage + (threadIdx.x - lane) * 3;\n"
                     "      st[3 * lane] = make_float4(rgb[0], rgb[1], rgb[2], rgb[3]);\n"
                     "      st[3 * lane + 1] = make_float4(rgb[4], rgb[5], rgb[6], rgb[7]);\n"
                     "      st[3 * lane + 2] = make_float4(rgb[8], rgb[9], rgb[10], rgb[11]);\n"
                     "      __syncwarp();\n"
                     "      float4* w4 = reinterpret_cast<float4*>(o) - 3 * lane;\n"
                     "      for (int k = 0; k < 3; ++k) w4[32 * k + lane] = st[32 * k + lane];\n"
                     "      __syncwarp();\n"
                     "    } else if (kVec) {\n"
                     "      float4* o4 = reinterpret_cast<float4*>(o);\n")],
    "noprims": [("    for (int p = 0; p < P; ++p) {\n      const float4* r4",
                 "    for (int p = 0; p < 0; ++p) {\n      const float4* r4")],
    "noprologue": [
        ("  for (int i = threadIdx.x; i < n_env * P; i += kThreads)\n",
         "  for (int i = threadIdx.x; i < 0; i += kThreads)\n"),
        ("  for (int e = threadIdx.x; e < n_env; e += kThreads) {\n"
         "    const int env = env0 + e;\n    envs[",
         "  for (int e = threadIdx.x; e < 0; e += kThreads) {\n"
         "    const int env = env0 + e;\n    envs["),
        ("  if (threadIdx.x < 12) lights[threadIdx.x] = a.light[threadIdx.x];\n"
         "  __syncthreads();\n", "")],
    "constdirs": [("    const float4 v0 = src[0], v1 = src[1], v2 = src[2];\n",
                   "    const float z_ = static_cast<float>(a.HW) * 1e-9f;\n"
                   "    const float4 v0 = make_float4(-0.7f, z_, -0.7f, -0.7f),"
                   " v1 = make_float4(z_, -0.7f, -0.7f, z_),"
                   " v2 = make_float4(-0.7f, -0.7f, z_, -0.7f);\n")],
    "fastrcp": [("            const float inv = __frcp_rn(safe_dir(db[ax]));\n",
                 "            const float inv = "
                 "__fdividef(1.f, safe_dir(db[ax]));\n")],
    "nonormal": [("          if (t_p < best_t[j]) {\n            best_t[j] = t_p;\n"
                  "            best_p[j] = p;\n            const float dn",
                  "          if (t_p < -best_t[j]) {\n            best_t[j] = t_p;\n"
                  "            best_p[j] = p;\n            const float dn")],
    "minblocks2": [("constexpr int kMinBlocks = 3;",
                    "constexpr int kMinBlocks = 2;")],
    "minblocks4": [("constexpr int kMinBlocks = 3;",
                    "constexpr int kMinBlocks = 4;")],
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def build_variant(name: str, source: str, symbol: str, argtypes):
    """Compile one patched source into its own library → its C function."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    work = REPO / "build" / f"probe_raycast_{name}"
    work.mkdir(parents=True, exist_ok=True)
    (work / "raycast.cu").write_text(source)
    (work / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    lib = work / "libraycast.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(work / "raycast.cu")], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{done.stdout}\n{done.stderr}")
    res = [l.strip() for l in (done.stdout + done.stderr).splitlines()
           if "registers" in l]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, res


def sass_of(name: str, out: Path) -> dict | None:
    """Disassemble a variant's library into ``out`` and count the SASS
    instructions of the float4 kernel: in all, and up to its landmarks
    (the prologue ends at the barrier, the per-env loop at the last store).
    The split of the loop into plane, bounding test, slab, sphere and
    shading is read off the branch targets in the dump by hand."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = REPO / "build" / f"probe_raycast_{name}" / "libraycast.so"
    done = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True)
    if done.returncode:
        print(f"cuobjdump failed: {done.stderr[:200]}", flush=True)
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(done.stdout)
    body = next((p for p in done.stdout.split("Function : ")
                 if "raycast_kernelILb1E" in p[:200]), "")
    ins = re.findall(r"^\s+/\*[0-9a-f]{4,5}\*/\s+(.*?);", body, re.M)
    first = lambda op: next((i for i, t in enumerate(ins) if op in t), None)
    last = lambda op: max((i for i, t in enumerate(ins) if op in t),
                          default=None)
    return dict(instructions=len(ins), barrier_at=first("BAR.SYNC"),
                ray_loads_at=first("LDG.E.128"), first_rsqrt_at=first("MUFU.RSQ"),
                last_store_at=last("STG.E.128"),
                reciprocals=sum("MUFU.RCP" in t for t in ins))


def patched(name: str, text: str | None = None) -> str:
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    if text is None:
        text = (_build.CSRC / "raycast.cu").read_text()
    for old, new in PATCHES[name]:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer has its anchor")
        text = text.replace(old, new)
    return text


def timed(fn, iters=50):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def scene_sets(dev):
    import torch
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv, LiftState
    from latent_diffusion_planning_tpu_torch.envs.lift_physics import (
        LiftPhysicsEnv)
    from latent_diffusion_planning_tpu_torch.ops import render as R

    env = LiftEnv(render_images=False)
    g = torch.Generator(device=dev).manual_seed(5)
    state = env.reset_state(N_ENVS, g)
    u = torch.rand(N_ENVS, 4, generator=g, device=dev)
    state = LiftState(eef_pos=state.cube_pos + (u[:, :3] - 0.5) * 0.3,
                      gripper=u[:, 3], cube_pos=state.cube_pos,
                      cube_yaw=state.cube_yaw, grasped=state.grasped, t=state.t)
    lift3 = env.scene(state)
    lift1 = R.Scene(**{k: (v[:, :1] if k in ("pos", "rot", "size", "color",
                                            "kind") else v)
                       for k, v in lift3.__dict__.items()})
    penv = LiftPhysicsEnv(render_images=False)
    ps = penv.reset_state(N_ENVS, g)
    for _ in range(6):
        ps = penv.transition(ps, penv.scripted_action(ps))[0]
    return {"lift1": (lift1, env.camera), "lift3": (lift3, env.camera),
            "phys6": (penv.scene(ps), penv.camera)}


def previous_args(scene, rays, cam, out):
    """The packing the previous wrapper did before each launch, and its
    argument list."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops import render as R
    N, P = scene.pos.shape[:2]
    packed = torch.cat([scene.pos, scene.rot.reshape(N, P, 9), scene.size,
                        scene.color, scene.kind.float()[..., None],
                        scene.pos.new_zeros(N, P, 3)], -1).float().contiguous()
    plane = torch.cat([scene.plane_z.reshape(N, 1),
                       scene.plane_color.expand(N, 3)], -1).float().contiguous()
    light = R.light_rig(scene.pos.device)
    ox, oy, oz = cam.pos
    return ([packed.data_ptr(), None, plane.data_ptr(), rays.data_ptr(),
             light.data_ptr(), ox, oy, oz, R.AMBIENT, out.data_ptr(), N,
             H * W, P, 0, 0,
             torch.cuda.current_stream().cuda_stream], (packed, plane, light))


def main() -> int:
    import torch
    from latent_diffusion_planning_tpu_torch.ops import render as R
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build, raycast

    dev = torch.device("cuda")
    where = card()
    say = lambda **kw: print(json.dumps({**kw, "card": where}), flush=True)
    P_, I, F = _build.P, _build.I, _build.F
    jobs = {n: (patched(n), "ldp_raycast", raycast.ARGTYPES) for n in PATCHES}
    jobs["noprims+stagedstore"] = (
        patched("noprims", patched("stagedstore")), "ldp_raycast",
        raycast.ARGTYPES)
    if PREVIOUS.exists():
        jobs["previous"] = (PREVIOUS.read_text(), "ldp_raycast",
                            [P_] * 5 + [F] * 4 + [P_] + [I] * 5 + [P_])
    else:
        print(f"no {PREVIOUS.relative_to(REPO)}: the previous kernel is not "
              "timed", flush=True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda n: build_variant(n, *jobs[n]), jobs)))
    for name in ("full", "minblocks2", "minblocks4", "previous"):
        if name in built:
            say(variant=name, ptxas=built[name][1])

    if "--sass" in sys.argv:
        sass = sass_of("full", Path(sys.argv[sys.argv.index("--sass") + 1]))
        if sass:
            say(sass_of_the_float4_kernel=sass)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    say(sm_clocks_max_and_now=clocks.stdout.strip())

    sets = scene_sets(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for set_name, (scene, cam) in sets.items():
        rays = R.camera_rays(cam, H, W, dev)
        args, out, keep = raycast.launch_args(scene, cam, H, W, 0, rays)
        for name in built:
            if name == "previous":
                continue
            fn = built[name][0]
            say(scenes=set_name, variant=name,
                ms=timed(lambda: fn(*args, stream)))
        fn = built["full"][0]
        for E in (1, 2, 3, 4, 6, 8, 16):
            a_e, _, keep_e = raycast.launch_args(scene, cam, H, W, 0, rays, E)
            say(scenes=set_name, variant="full", envs_per_block=E,
                ms=timed(lambda: fn(*a_e, stream)))
        say(scenes=set_name, variant="full, through the wrapper",
            ms=timed(lambda: raycast.render_batch_cuda(scene, cam, H, W, 0,
                                                       rays)))
        if "previous" not in built:
            continue
        old = built["previous"][0]
        flat = rays.reshape(-1, 3).contiguous()
        old_args, keep_old = previous_args(scene, flat, cam, out)
        new = built["full"][0]
        turns = []
        for who in ("previous", "full", "full", "previous"):
            if who == "full":
                turns.append((who, timed(lambda: new(*args, stream))))
            else:
                turns.append((who, timed(lambda: old(*old_args))))
        say(scenes=set_name, in_turns=turns)
        say(scenes=set_name, variant="previous, with its packing",
            ms=timed(lambda: old(*previous_args(scene, flat, cam, out)[0])))
        got = torch.empty_like(out)
        o_args, _k = previous_args(scene, flat, cam, got)
        old(*o_args)
        new(*args, stream)
        torch.cuda.synchronize()
        diff = (got - out).abs().amax(-1)
        say(scenes=set_name, new_vs_previous_frac_within_2=float(
            (diff < 2.0).float().mean()), max_abs_diff=float(diff.max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
