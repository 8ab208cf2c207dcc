#!/usr/bin/env python
"""Record ``tests/fixtures/aloha_golden.npz`` from the JAX package's ALOHA
envs, for ``tests/test_torch_aloha*.py``.

Usage: JAX_PLATFORMS=cpu python tools/record_aloha_fixture.py
       [--steps 24] [--out tests/fixtures/aloha_golden.npz] [--experts]

An XLA-CPU compile of the transfer-cube step takes minutes and the JAX
package's own ALOHA tests are ``slow``, so the port's tests read what this
writes. Keys:

- ``kin_*``: the ViperX chains of both arms on 16 seeded joint vectors:
  ``fk`` positions and quaternions, one ``dls_ik_step`` toward seeded
  targets, ``arm_step`` with and without ``grip_rate``, the cube env's
  ``pad_positions``, ``holding``/``touching`` on seeded objects, and the
  ``wrist64`` camera (pos, lookat, up);
- ``{cube,ins}_u``: the uniforms a reset of 8 envs from ``PRNGKey(1)``
  draws (``reset_draws``'s input), and the spawned object positions;
- ``{cube,ins}_*`` per step: ``--steps`` steps of the scripted expert
  through one jitted, vmapped step (the JAX engine's host loop): the
  executed actions, both arms' joints and grippers, the object poses, the
  reward, success and, for the cube, ``contact_flags``; insertion runs its
  whole 160-step episode (no contact physics, so no chaos);
- ``{cube,ins}_frames_{box,kdop}``: the XLA renderer's ``wrist64`` frames of
  the first 4 envs at reset and after the last step, in both ``mesh_mode``s,
  with the states they were rendered from.

``--experts`` instead adds to the existing fixture the success per step of
the JAX experts over ``EXPERT_EPISODES`` episodes each
(``engine.run_scripted_collection(env, n, PRNGKey(1), episode_len=...)``,
the call the JAX package's slow ``test_scripted_*`` tests make, over more
seeds), as ``{cube,ins}_expert_success`` (episodes, steps).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from latent_diffusion_planning_tpu.envs import aloha_base as B  # noqa: E402
from latent_diffusion_planning_tpu.envs import aloha_cube as AC  # noqa: E402
from latent_diffusion_planning_tpu.envs import aloha_insertion as AI  # noqa: E402
from latent_diffusion_planning_tpu.envs import aloha_constants as C  # noqa: E402
from latent_diffusion_planning_tpu.envs.physics import kinematics as K  # noqa: E402
from latent_diffusion_planning_tpu.rollout import engine  # noqa: E402

N_ENVS = 8
N_FRAMES = 4
EXPERT_EPISODES = {"cube": (32, 120), "ins": (32, 160)}
ROOT = Path(__file__).resolve().parents[1]
ENVS = {"cube": AC.AlohaTransferCubeEnv, "ins": AI.AlohaInsertionEnv}


def _arm(q, grip, qvel=None, grip_vel=None):
    n = q.shape[0]
    return B.ArmState(qpos=jnp.asarray(q, jnp.float32),
                      qvel=jnp.zeros((n, 6)) if qvel is None else qvel,
                      grip=jnp.asarray(grip, jnp.float32),
                      grip_vel=jnp.zeros((n,)) if grip_vel is None
                      else grip_vel)


def record_kinematics() -> dict:
    rs = np.random.RandomState(0)
    n = 16
    q = (np.asarray(C.START_ARM_QPOS)[None]
         + rs.uniform(-0.6, 0.6, (n, 6))).astype(np.float32)
    grip = rs.uniform(0.0, 1.0, n).astype(np.float32)
    out = {"kin_q": q, "kin_grip": grip}
    for side, chain in (("L", B.LEFT_CHAIN), ("R", B.RIGHT_CHAIN)):
        ps, qs = jax.vmap(lambda x: K.fk(chain, x))(jnp.asarray(q))
        tip = np.asarray(ps[:, -1])
        target = (tip + rs.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
        ik = jax.vmap(lambda x, t: K.dls_ik_step(
            chain, x, t, lo=C.ARM_JOINT_LO, hi=C.ARM_JOINT_HI))(
                jnp.asarray(q), jnp.asarray(target))
        arm = _arm(q, grip)
        pads = jax.vmap(lambda a: AC.pad_positions(chain, a))(arm)
        obj = (tip + rs.uniform(-0.06, 0.06, (n, 3))).astype(np.float32)
        was = rs.uniform(size=n) < 0.5
        out.update({
            f"kin_{side}_pos": ps, f"kin_{side}_quat": qs,
            f"kin_{side}_target": target, f"kin_{side}_ik": ik,
            f"kin_{side}_pad_a": pads[0], f"kin_{side}_pad_b": pads[1],
            f"kin_{side}_obj": obj, f"kin_{side}_was_held": was,
            f"kin_{side}_holding": jax.vmap(
                lambda a, o, w: B.holding(chain, a, o, w))(
                    arm, jnp.asarray(obj), jnp.asarray(was)),
            f"kin_{side}_touching": jax.vmap(
                lambda a, o: B.touching(chain, a, o))(arm, jnp.asarray(obj)),
        })
    # arm_step from a moving state, with and without the grip rate cap
    q_target = (q + rs.uniform(-0.3, 0.3, (n, 6))).astype(np.float32)
    g_target = rs.uniform(-0.2, 1.2, n).astype(np.float32)
    out.update(kin_q_target=q_target, kin_g_target=g_target)
    arm = _arm(q, grip)
    for tag, rate in (("free", None), ("rate", AC.GRIP_RATE)):
        new = jax.vmap(lambda a, t, g: B.arm_step(a, t, g, grip_rate=rate))(
            arm, jnp.asarray(q_target), jnp.asarray(g_target))
        out.update({f"kin_step_{tag}_{k}": getattr(new, k)
                    for k in ("qpos", "qvel", "grip", "grip_vel")})
    cam = jax.vmap(B.wrist64_camera)(arm)
    out.update(kin_cam_pos=cam.pos, kin_cam_lookat=cam.lookat,
               kin_cam_up=cam.up)
    return {k: np.asarray(v) for k, v in out.items()}


def _uniforms(name: str, keys) -> np.ndarray:
    """The uniforms in [0, 1) each env's reset draws, in reset order."""
    def cube(k):
        x, y = jax.random.split(k)
        return jnp.stack([jax.random.uniform(x, ()), jax.random.uniform(y, ())])

    def ins(k):
        p, s = jax.random.split(k)
        return jnp.stack([
            jax.random.uniform(p, ()),
            jax.random.uniform(jax.random.fold_in(p, 1), ()),
            jax.random.uniform(s, ()),
            jax.random.uniform(jax.random.fold_in(s, 1), ())])
    return np.asarray(jax.vmap(cube if name == "cube" else ins)(keys))


def _arms(states) -> dict:
    return {f"{side}_{k}": np.asarray(getattr(getattr(states, arm), k))
            for side, arm in (("l", "left"), ("r", "right"))
            for k in ("qpos", "qvel", "grip", "grip_vel")}


def _objects(name, states) -> dict:
    if name == "cube":
        return {"obj_pos": np.asarray(states.bodies.pos),
                "obj_quat": np.asarray(states.bodies.quat),
                "obj_linvel": np.asarray(states.bodies.linvel),
                "obj_angvel": np.asarray(states.bodies.angvel)}
    return {k: np.asarray(getattr(states, k))
            for k in ("peg_pos", "socket_pos", "peg_held", "socket_held")}


def _frames(name, states, mode) -> np.ndarray:
    env = ENVS[name](render_images=True, image_size=64, mesh_mode=mode)
    one = jax.jit(env.render)
    return np.stack([np.asarray(one(jax.tree_util.tree_map(
        lambda x: x[i], states))) for i in range(N_FRAMES)])


def record_task(name: str, steps: int) -> dict:
    env = ENVS[name](render_images=False)
    keys = jax.random.split(jax.random.PRNGKey(1), N_ENVS)
    states, obs = jax.jit(jax.vmap(env.reset))(keys)
    rec = {"u": _uniforms(name, keys),
           **{f"reset_{k}": v for k, v in _arms(states).items()},
           **{f"reset_{k}": v for k, v in _objects(name, states).items()},
           "reset_env_state": np.asarray(obs["env_state"])}
    for mode in ("box", "kdop"):
        rec[f"frames_{mode}_first"] = _frames(name, states, mode)

    @jax.jit
    def step(s):
        a = jax.vmap(env.scripted_action)(s)
        s, o, r, ok = jax.vmap(env.step)(s, a)
        flags = (jax.vmap(env.contact_flags)(s) if name == "cube" else {})
        return s, a, o, r, ok, flags

    keep: dict = {}
    for t in range(steps):
        states, a, o, r, ok, flags = step(states)
        row = {"actions": a, "reward": r, "success": ok,
               "qpos_obs": o["qpos"], "qvel_obs": o["qvel"],
               "env_state": o["env_state"], **_arms(states),
               **_objects(name, states),
               **{f"flag_{k}": v for k, v in flags.items()}}
        for k, v in row.items():
            keep.setdefault(k, []).append(np.asarray(v))
        print(f"{name}: step {t + 1}/{steps}", flush=True)
    rec.update({k: np.stack(v, 1) for k, v in keep.items()})
    rec.update({f"last_{k}": v for k, v in _arms(states).items()})
    rec.update({f"last_{k}": v for k, v in _objects(name, states).items()})
    for mode in ("box", "kdop"):
        rec[f"frames_{mode}_last"] = _frames(name, states, mode)
    return {f"{name}_{k}": np.asarray(v) for k, v in rec.items()}


def expert_success() -> dict:
    out = {}
    for name, (n, steps) in EXPERT_EPISODES.items():
        env = ENVS[name](render_images=False, episode_len=steps)
        got = engine.run_scripted_collection(env, n, jax.random.PRNGKey(1),
                                             episode_len=steps)
        success = np.asarray(got["success"])
        out[f"{name}_expert_success"] = success
        won = success.any(1)
        print(f"{name} expert over {n} episodes x {steps} steps: "
              f"{won.sum()} succeed ({won.mean():.3f})", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--experts", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures"
                                         / "aloha_golden.npz"))
    args = ap.parse_args()
    if args.experts:
        out = {k: v for k, v in np.load(args.out).items()
               if "_expert_" not in k}
        out.update(expert_success())
        np.savez_compressed(args.out, **out)
        print(f"added the experts' success to {args.out}")
        return
    out = record_kinematics()
    out.update(record_task("cube", args.steps))
    out.update(record_task("ins", EXPERT_EPISODES["ins"][1]))
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays")


if __name__ == "__main__":
    main()
