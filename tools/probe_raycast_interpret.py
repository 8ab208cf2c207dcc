#!/usr/bin/env python
"""How the JAX package's Pallas ray-caster scales with convex half-spaces in
interpret mode, on the CPU: does it take a scene past kernel C's shared
memory (``MAX_SMEM_BYTES``, 200 KB: 12800 half-spaces of 16 bytes)?

    JAX_PLATFORMS=cpu python tools/probe_raycast_interpret.py K [K ...]

For each K it renders one convex prim of K random half-spaces (8 × 8
pixels, one tile) with ``render_pallas(..., interpret=True)`` and prints the
call's seconds and its largest difference from the XLA renderer
(``ops/render.render``). The kernel unrolls its loop over the half-spaces
(one chain of traced operations a plane), so its trace and compile grow
faster than K; the printed times show where the interpret mode stops.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def probe(K: int) -> dict:
    import jax.numpy as jnp
    from latent_diffusion_planning_tpu.ops import render as R
    from latent_diffusion_planning_tpu.ops.pallas.raycast import render_pallas
    rng = np.random.default_rng(0)
    n = rng.normal(size=(K, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    planes = np.concatenate([n, np.full((K, 1), 0.05)], 1)[None]
    scene = R.Scene(pos=jnp.asarray([[0.0, 0.0, 0.9]]), rot=jnp.eye(3)[None],
                    size=jnp.full((1, 3), 0.05),
                    color=jnp.asarray([[0.8, 0.2, 0.2]]),
                    kind=jnp.asarray([2], jnp.int32),
                    planes=jnp.asarray(planes, jnp.float32))
    cam = R.look_at((0.6, 0.0, 1.2), (0.0, 0.0, 0.9))
    t0 = time.perf_counter()
    img = np.asarray(render_pallas(scene, cam, 8, 8, interpret=True,
                                   n_convex=1))
    secs = time.perf_counter() - t0
    ref = np.asarray(R.render(scene, cam, 8, 8))
    return dict(K=K, half_space_bytes=16 * K, seconds=secs,
                max_abs_diff=float(np.abs(img - ref).max()))


def main() -> int:
    for K in (int(a) for a in sys.argv[1:] or ["64", "256"]):
        print(probe(K), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
