#!/usr/bin/env python
"""Compare Can recipe arms scored by ``tools/run_can_ldp_torch.py``.

    python tools/compare_can_arms.py [--step 30000] NAME=PATH.json ...

Prints each arm's pooled success at ``--step`` through the kernels (and on
the plain loop where scored) with its Wilson 95% interval, then Fisher's
exact p (two-sided) between every pair of arms. With arms named
``card_d<D>`` and ``cpu_d<D>`` (demos collected on the card or on the CPU
at demo draw D, as ``tools/run_full_length_torch.sh can_draws`` names
them), also the demo-draw rule: the card carries the gap if its arm is
below the CPU arm at every draw by at least 0.03 with p < 0.01; the gap is
the draws' spread if the card arm is at or above the CPU arm at some draw,
or if the two draws of one device differ by at least as much as the two
devices at one draw; anything else stays open. With arms named
``card_v<S>`` and ``cpu_v<S>`` (the VAE trained and its latents encoded on
the card or on the CPU at VAE seed S, as ``tools/run_full_length_torch.sh
can_vae_draws`` names them), the VAE-draw rule on the pooled rates of each
device: the card's VAE stage carries the gap if every card arm is below
every CPU arm and the pooled card rate is below the pooled CPU rate by at
least 0.03 with Fisher's p < 0.01; the gap is the VAE draw's spread if the
two devices' ranges of rates overlap; anything else stays open.
"""

import argparse
import itertools
import json
import re
import sys
from pathlib import Path

from scipy.stats import fisher_exact

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run_can_ldp_torch import wilson  # noqa: E402

KERNELS = "kernels C, B, A"


def pooled(path: Path, step: int) -> dict:
    """{route: (successes, episodes)} at ``step``."""
    rec = json.loads(path.read_text())
    return {c["route"]: (c["successes"], c["n_episodes"])
            for c in rec["checkpoints"] if c["step"] == step}


def verdict(arms: dict) -> str:
    draws = sorted({int(m.group(1)) for n in arms
                    if (m := re.fullmatch(r"(?:card|cpu)_d(\d+)", n))})
    pairs = [d for d in draws if f"card_d{d}" in arms and f"cpu_d{d}" in arms]
    if not pairs:
        return "no card/CPU pair of one draw"
    rate = lambda n: arms[n][0] / arms[n][1]
    gaps = {d: rate(f"cpu_d{d}") - rate(f"card_d{d}") for d in pairs}
    p = {d: fisher_exact([[arms[f"card_d{d}"][0],
                           arms[f"card_d{d}"][1] - arms[f"card_d{d}"][0]],
                          [arms[f"cpu_d{d}"][0],
                           arms[f"cpu_d{d}"][1] - arms[f"cpu_d{d}"][0]]])[1]
         for d in pairs}
    spans = [abs(rate(f"{dev}_d{a}") - rate(f"{dev}_d{b}"))
             for dev in ("card", "cpu") for a, b in
             itertools.combinations(pairs, 2)]
    print("card below CPU by draw: " + ", ".join(
        f"d{d} {gaps[d]:+.4f} (p {p[d]:.3g})" for d in pairs))
    if len(pairs) >= 2 and all(gaps[d] >= 0.03 and p[d] < 0.01
                               for d in pairs):
        return "the card carries the gap"
    if any(gaps[d] <= 0 for d in pairs) or (
            spans and max(spans) >= min(abs(g) for g in gaps.values())):
        return "spread of the demo draw"
    return "open"


def vae_verdict(arms: dict) -> str:
    """The VAE-draw rule over arms ``card_v<S>`` and ``cpu_v<S>``."""
    dev = {d: {n: arms[n] for n in arms if re.fullmatch(rf"{d}_v\d+", n)}
           for d in ("card", "cpu")}
    if not (dev["card"] and dev["cpu"]):
        return "no card and CPU arms of VAE draws"
    rate = lambda v: v[0] / v[1]
    pooled = {d: (sum(v[0] for v in a.values()), sum(v[1] for v in a.values()))
              for d, a in dev.items()}
    (kc, nc), (kp, np_) = pooled["card"], pooled["cpu"]
    p = fisher_exact([[kc, nc - kc], [kp, np_ - kp]])[1]
    lo = {d: min(map(rate, a.values())) for d, a in dev.items()}
    hi = {d: max(map(rate, a.values())) for d, a in dev.items()}
    print(f"VAE draws pooled: card {kc / nc:.4f} ({kc} of {nc}), CPU "
          f"{kp / np_:.4f} ({kp} of {np_}); card below CPU by "
          f"{kp / np_ - kc / nc:+.4f}, Fisher p {p:.3g}; ranges card "
          f"[{lo['card']:.4f}, {hi['card']:.4f}], CPU [{lo['cpu']:.4f}, "
          f"{hi['cpu']:.4f}]")
    if hi["card"] < lo["cpu"] and kp / np_ - kc / nc >= 0.03 and p < 0.01:
        return "the card's VAE stage carries the gap"
    if lo["card"] <= hi["cpu"] and lo["cpu"] <= hi["card"]:
        return "spread of the VAE draw"
    return "open"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", type=int, default=30000)
    ap.add_argument("arms", nargs="+", help="NAME=PATH.json")
    args = ap.parse_args()
    arms, plain = {}, {}
    for spec in args.arms:
        name, path = spec.split("=", 1)
        routes = pooled(Path(path), args.step)
        arms[name] = routes[KERNELS]
        plain.update({name: v for r, v in routes.items() if r != KERNELS})
    for name, (k, n) in arms.items():
        lo, hi = wilson(k, n)
        extra = ""
        if name in plain:
            pk, pn = plain[name]
            extra = f"; plain loop {pk / pn:.4f} ({pk} of {pn})"
        print(f"{name}: {k / n:.4f} [{lo:.3f}, {hi:.3f}] ({k} of {n}) at "
              f"{args.step}{extra}")
    for a, b in itertools.combinations(arms, 2):
        (ka, na), (kb, nb) = arms[a], arms[b]
        p = fisher_exact([[ka, na - ka], [kb, nb - kb]])[1]
        print(f"{a} against {b}: {ka / na - kb / nb:+.4f}, Fisher p {p:.3g}")
    if any(re.fullmatch(r"(?:card|cpu)_d\d+", n) for n in arms):
        print(f"demo-draw rule: {verdict(arms)}")
    if any(re.fullmatch(r"(?:card|cpu)_v\d+", n) for n in arms):
        print(f"VAE-draw rule: {vae_verdict(arms)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
