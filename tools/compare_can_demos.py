#!/usr/bin/env python
"""Compare two Can demo files of the same spawns, collected on two devices
(for example the port's ``tools/collect_demos_torch.py`` on the CPU and on
the card, seeds 0 / 77; frames need not be kept), or of two demo draws.

    python tools/compare_can_demos.py A.npz B.npz

Prints, for each file, the demos and their mean actions; then, over the
spawns both kept (matched by the can's first position), the step at which
the two cans first part by more than 1e-3 (median and quartiles), and the
can's mean height and lateral position at steps along the episode and its
mean peak height. The expert flings the can into the bin, so its path
after the grasp is where a difference between the two contact engines
shows. Last, each file's fling over all its demos, each figure as mean,
standard deviation and quartiles across demos: the peak height, the step
of the peak, the step at which the can first comes down to the bin's
success height after it (its landing), and the share of demos whose can
lands in the bin (``CanPhysicsEnv``'s goal test at the landing step) and
whose can ends in it (at the last step).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = (60, 100, 140, 180, 220, 299)
PART = 1e-3


def load(path: str) -> list[dict]:
    with np.load(path) as z:
        names = sorted({k.split("/")[1] for k in z.files
                        if k.startswith("data/demo_")},
                       key=lambda n: int(n.split("_")[1]))
        return [dict(obj=z[f"data/{n}/obs/object"][:, :3],
                     act=z[f"data/{n}/actions"]) for n in names]


def spread(v: np.ndarray) -> str:
    """mean ± std [quartiles] of one figure across demos."""
    q = np.percentile(v, [25, 50, 75])
    return (f"{v.mean():.3f} ± {v.std():.3f} "
            f"[{q[0]:.3f} {q[1]:.3f} {q[2]:.3f}]")


def fling(demos: list[dict]) -> dict:
    """Per demo: peak height, its step, the landing step (the first step
    after the peak at or below the bin's success height; the last step if
    the can stays above it) and whether the can is in the bin there and
    at the last step."""
    import torch
    from latent_diffusion_planning_tpu_torch.envs import pick_place_physics
    env = pick_place_physics.CanPhysicsEnv(render_images=False)
    c = env._const("cpu")
    ceiling = pick_place_physics.TABLE_Z + env.obj_top + 0.02
    out = {"peak_z": [], "peak_step": [], "landing_step": [],
           "lands_in_bin": [], "ends_in_bin": []}
    in_bin = lambda p: float(env._in_goal(
        torch.from_numpy(p[None].astype(np.float32)), c)[0])
    for d in demos:
        z = d["obj"][:, 2]
        top = int(np.argmax(z))
        down = np.nonzero(z[top:] <= ceiling)[0]
        out["peak_z"].append(z[top])
        out["peak_step"].append(top)
        land = top + down[0] if len(down) else len(z) - 1
        out["landing_step"].append(land)
        out["lands_in_bin"].append(in_bin(d["obj"][land]))
        out["ends_in_bin"].append(in_bin(d["obj"][-1]))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def main() -> int:
    a, b = load(sys.argv[1]), load(sys.argv[2])
    for label, demos in (("A", a), ("B", b)):
        acts = np.concatenate([d["act"] for d in demos])
        print(f"{label}: {len(demos)} demos, mean action "
              f"{np.round(acts.mean(0), 3).tolist()}")
    key = lambda d: tuple(np.round(d["obj"][0, :2], 4))
    by_spawn = {key(d): d for d in b}
    pairs = [(d, by_spawn[key(d)]) for d in a if key(d) in by_spawn]
    if pairs:
        part = []
        for d, e in pairs:
            off = np.abs(d["obj"] - e["obj"]).max(1) > PART
            part.append(int(np.argmax(off)) if off.any() else len(off))
        print(f"{len(pairs)} spawns in both; the cans part by {PART} at step "
              f"{np.median(part):.0f} (quartiles "
              f"{np.percentile(part, 25):.0f}-{np.percentile(part, 75):.0f})")
        for label, demos in (("A", [p[0] for p in pairs]),
                             ("B", [p[1] for p in pairs])):
            path = np.stack([d["obj"] for d in demos])       # (n, T, 3)
            rows = ", ".join(f"{t}: z {path[:, t, 2].mean():.3f} y "
                             f"{path[:, t, 1].mean():.3f}" for t in STEPS)
            print(f"{label}: peak z {path[:, :, 2].max(1).mean():.3f}; "
                  f"{rows}")
    else:
        print("no spawn in both files (two draws): they are compared by "
              "their flings alone")
    for label, demos in (("A", a), ("B", b)):
        print(f"{label} fling over {len(demos)} demos: " + "; ".join(
            f"{k} {spread(v)}" for k, v in fling(demos).items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
