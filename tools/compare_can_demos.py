#!/usr/bin/env python
"""Compare two Can demo files of the same spawns, collected on two devices
(for example the port's ``tools/collect_demos_torch.py`` on the CPU and on
the card, seeds 0 / 77; frames need not be kept).

    python tools/compare_can_demos.py A.npz B.npz

Prints, for each file, the demos and their mean actions; then, over the
spawns both kept (matched by the can's first position), the step at which
the two cans first part by more than 1e-3 (median and quartiles), and the
can's mean height and lateral position at steps along the episode and its
mean peak height. The expert flings the can into the bin, so its path
after the grasp is where a difference between the two contact engines
shows.
"""

import sys

import numpy as np

STEPS = (60, 100, 140, 180, 220, 299)
PART = 1e-3


def load(path: str) -> list[dict]:
    with np.load(path) as z:
        names = sorted({k.split("/")[1] for k in z.files
                        if k.startswith("data/demo_")},
                       key=lambda n: int(n.split("_")[1]))
        return [dict(obj=z[f"data/{n}/obs/object"][:, :3],
                     act=z[f"data/{n}/actions"]) for n in names]


def main() -> int:
    a, b = load(sys.argv[1]), load(sys.argv[2])
    for label, demos in (("A", a), ("B", b)):
        acts = np.concatenate([d["act"] for d in demos])
        print(f"{label}: {len(demos)} demos, mean action "
              f"{np.round(acts.mean(0), 3).tolist()}")
    key = lambda d: tuple(np.round(d["obj"][0, :2], 4))
    by_spawn = {key(d): d for d in b}
    pairs = [(d, by_spawn[key(d)]) for d in a if key(d) in by_spawn]
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
        print(f"{label}: peak z {path[:, :, 2].max(1).mean():.3f}; {rows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
