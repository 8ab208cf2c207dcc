#!/usr/bin/env python
"""Record ``tests/fixtures/pick_place_golden.npz`` from the JAX package's
Can and Square envs, for ``tests/test_torch_pick_place.py``.

Usage: JAX_PLATFORMS=cpu python tools/record_pick_place_fixture.py
       [--steps 20] [--out tests/fixtures/pick_place_golden.npz]
       [--experts [--env SquarePhysicsEnv --seeds LO HI]]
       [--merge PART.npz ...] [--contact-step]

An XLA-CPU compile of these envs' steps takes minutes and a physics step
seconds, so the tests read what this writes (about 20 minutes on a CPU).
For each of ``CanPhysicsEnv`` and ``SquarePhysicsEnv`` (keys prefixed with
the class name):

- the reset of 8 envs from ``PRNGKey(1)``: spawn (``obj_xy``,
  ``obj_yaw``), bodies, joints, targets, gripper and observations
  (``reset_*``);
- ``--steps`` control steps of the scripted expert through one jitted,
  vmapped step (the JAX engine's host loop): executed actions, object
  pose, eef, reward, success, ``holding`` and the 14-dim ``object``
  observation after each step;
- the XLA renderer's 32×32 frames of the first and last states, rendered
  one env at a time outside ``jit`` (Square's render calls ``float()`` on a
  constant and fails under a trace);
- ``check_success`` of the object placed at each of ``SUCCESS_CASES``, and
  ``holding`` of three pad placements (open at home, squeezing the object,
  squeezing beside it).

For ``CanEnv`` and ``SquareEnv`` (kinematic): the same reset, ``--steps``
expert steps (actions, object, grasp, reward, success, final
observations), renders of four moved states, and ``check_success`` of each
case held and not held.

``--experts`` instead runs only the two physics experts, through the call
``tests/test_pick_place_physics.py::test_scripted_expert`` makes
(``engine.run_scripted_collection(env, 8, PRNGKey(1), episode_len=300)``),
and adds to the existing fixture each episode's spawn
(``{name}_expert_obj_xy``, ``{name}_expert_obj_yaw``) and success per step
(``{name}_expert_success``, (episodes, 300)). Can runs 32 episodes, seeds
0–31, Square 8, seeds 0–7; seeds 0–7 are the JAX test's own episodes.
Each batch of 8 seeds runs in its own process (a step of 8 envs takes
about 15 s on one core, so this takes over an hour).

``--experts --env NAME --seeds LO HI`` runs the expert of one env over
seeds LO..HI-1 only, in batches of 8 (one process each, all at once), and
writes a fixture of its own to ``--out`` with the same keys plus
``{name}_expert_seeds``; ``tests/fixtures/square_expert_golden.npz`` holds
Square's seeds 8 and up. ``--merge`` joins such files into ``--out``,
ordered by seed, so that batches can run as separate processes (about 70
minutes a batch of 8 on one core each).

``--contact-step`` writes ``tests/fixtures/can_contact_golden.npz``: one
control step of JAX's ``CanPhysicsEnv`` from 72 states where the pads,
the can and the bin walls touch, as a policy's imprecise grasp leaves
them. The states come from the port's own expert on 8 envs, at 9 points
from the approach to the drop (steps 15 to 121), with the can's pose and
velocities perturbed (3 mm, 0.1 m/s, 1 rad/s) and random actions (about
3 minutes: the step's XLA compile).
"""

import argparse
import multiprocessing
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from latent_diffusion_planning_tpu.envs import pick_place as JK  # noqa: E402
from latent_diffusion_planning_tpu.envs import pick_place_physics as J  # noqa: E402
from latent_diffusion_planning_tpu.rollout import engine  # noqa: E402

N_ENVS = 8
EXPERT_STEPS = 300
EXPERT_EPISODES = {"CanPhysicsEnv": 32, "SquarePhysicsEnv": 8}
ROOT = Path(__file__).resolve().parents[1]
OBS_KEYS = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
            "robot0_joint_pos", "object")
# object positions: in the goal at rest, above it, beside it, just inside
# and just outside the xy tolerance, just below the height limit
SUCCESS_CASES = {
    "Can": [(0.17, 0.15, 0.825), (0.17, 0.15, 0.905), (0.47, 0.15, 0.825),
            (0.224, 0.15, 0.825), (0.226, 0.15, 0.825), (0.17, 0.15, 0.846)],
    "Square": [(0.12, 0.12, 0.81), (0.12, 0.12, 0.95), (0.22, 0.12, 0.81),
               (0.139, 0.12, 0.81), (0.141, 0.12, 0.81), (0.12, 0.12, 0.889)],
}


def _frames(env_cls, states, n) -> np.ndarray:
    env = env_cls(render_images=True, image_size=32)
    return np.stack([np.asarray(env.render(
        jax.tree_util.tree_map(lambda x: x[i], states))) for i in range(n)])


def _reset(env, n=N_ENVS):
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    return jax.jit(jax.vmap(env.reset))(keys)


def record_physics(name: str, steps: int) -> dict:
    env_cls = getattr(J, name)
    env = env_cls(render_images=False, episode_len=steps)
    states, obs = _reset(env)
    q = np.asarray(states.bodies.quat[:, J.OBJ])
    rec = {"obj_xy": np.asarray(states.bodies.pos[:, J.OBJ, :2]),
           "obj_yaw": 2 * np.arctan2(q[:, 3], q[:, 0]),
           "reset_pos": states.bodies.pos, "reset_quat": states.bodies.quat,
           "reset_qpos": states.qpos, "reset_eef_target": states.eef_target,
           "reset_gripper": states.gripper,
           **{f"reset_{k}": obs[k] for k in OBS_KEYS},
           "frames_first": _frames(env_cls, states, N_ENVS)}

    # success of the object at each case; holding of three pad placements
    cases = SUCCESS_CASES[name.replace("PhysicsEnv", "")]
    one = jax.tree_util.tree_map(lambda x: x[:1], states)
    many = jax.tree_util.tree_map(
        lambda x: jnp.repeat(x, len(cases), 0), one)
    many = many.replace(bodies=many.bodies.replace(
        pos=many.bodies.pos.at[:, J.OBJ].set(jnp.asarray(cases))))
    rec["success_cases"] = np.asarray(cases, np.float32)
    rec["success_verdicts"] = jax.jit(jax.vmap(env.check_success))(many)
    pos = np.array(states.bodies.pos[:3])
    gap = env._min_halfgap
    for i, dy in ((1, 0.0), (2, 0.05)):
        centre = pos[i, J.OBJ].copy()
        pos[i, J.PAD_L] = centre + np.array([-gap, 0.0, 0.0])
        pos[i, J.PAD_R] = centre + np.array([gap, 0.0, 0.0])
        pos[i, J.OBJ] = centre + np.array([0.0, dy, 0.0])
    three = jax.tree_util.tree_map(lambda x: x[:3], states)
    three = three.replace(bodies=three.bodies.replace(
        pos=jnp.asarray(pos),
        quat=three.bodies.quat.at[:, J.OBJ].set(
            jnp.asarray([1.0, 0.0, 0.0, 0.0]))))
    rec["holding_pos"], rec["holding_quat"] = (three.bodies.pos,
                                               three.bodies.quat)
    rec["holding_verdicts"] = jax.jit(jax.vmap(env.holding))(three)

    @jax.jit
    def step(s):
        a = jax.vmap(env.scripted_action)(s)
        s, obs, r, ok = jax.vmap(env.step)(s, a)
        return s, a, obs["object"], r, ok, jax.vmap(env.holding)(s)

    keep = {k: [] for k in ("actions", "obj_pos", "obj_quat", "eef",
                            "reward", "success", "holding", "object")}
    for t in range(steps):
        states, a, obj_obs, r, ok, held = step(states)
        for k, v in (("actions", a), ("obj_pos", states.bodies.pos[:, J.OBJ]),
                     ("obj_quat", states.bodies.quat[:, J.OBJ]),
                     ("eef", jax.vmap(lambda s: s.eef_pos)(states)),
                     ("reward", r), ("success", ok), ("holding", held),
                     ("object", obj_obs)):
            keep[k].append(np.asarray(v))
        print(f"{name}: step {t + 1}/{steps}", flush=True)
    rec.update({k: np.stack(v, 1) for k, v in keep.items()})
    rec["frames_last"] = _frames(env_cls, states, N_ENVS)
    return {f"{name}_{k}": np.asarray(v) for k, v in rec.items()}


def record_kinematic(name: str, steps: int) -> dict:
    env_cls = getattr(JK, name)
    env = env_cls(render_images=False, episode_len=steps)
    states, _ = _reset(env)
    rec = {"obj_xy": np.asarray(states.obj_pos[:, :2]),
           "obj_yaw": np.asarray(states.obj_yaw)}

    @jax.jit
    def step(s):
        a = jax.vmap(env.scripted_action)(s)
        s, obs, r, ok = jax.vmap(env.step)(s, a)
        return s, obs, a, r, ok

    keep = {k: [] for k in ("actions", "obj_pos", "grasped", "reward",
                            "success")}
    for t in range(steps):
        states, obs, a, r, ok = step(states)
        for k, v in (("actions", a), ("obj_pos", states.obj_pos),
                     ("grasped", states.grasped), ("reward", r),
                     ("success", ok)):
            keep[k].append(np.asarray(v))
        print(f"{name}: step {t + 1}/{steps}", flush=True)
    rec.update({k: np.stack(v, 1) for k, v in keep.items()})
    rec.update({f"last_{k}": obs[k] for k in OBS_KEYS})
    rec.update({f"last_{k}": getattr(states, k)
                for k in ("qpos", "eef_target", "gripper", "obj_yaw", "t")})

    # renders of four moved states: two objects lifted, one gripper closed
    moved = jax.tree_util.tree_map(lambda x: x[:4], states)
    moved = moved.replace(obj_pos=moved.obj_pos.at[2:, 2].add(0.1),
                          gripper=moved.gripper.at[1].set(0.2))
    rec.update({f"render_{k}": getattr(moved, k)
                for k in ("qpos", "eef_target", "gripper", "obj_pos",
                          "obj_yaw", "grasped", "t")})
    rec["render_frames"] = _frames(env_cls, moved, 4)

    cases = SUCCESS_CASES[name.replace("Env", "")]
    one = jax.tree_util.tree_map(lambda x: x[:1], states)
    verdicts = []
    for grasped in (False, True):
        many = jax.tree_util.tree_map(
            lambda x: jnp.repeat(x, len(cases), 0), one)
        many = many.replace(obj_pos=jnp.asarray(cases, jnp.float32),
                            grasped=jnp.full((len(cases),), grasped))
        verdicts.append(np.asarray(jax.vmap(env.check_success)(many)))
    rec["success_cases"] = np.asarray(cases, np.float32)
    rec["success_verdicts"] = np.stack(verdicts)    # (held?, case)
    return {f"{name}_{k}": np.asarray(v) for k, v in rec.items()}


def _expert_batch(job) -> dict:
    """The expert over the episodes ``seeds``, as the JAX test runs it."""
    name, seeds = job
    env = getattr(J, name)(render_images=False, episode_len=EXPERT_STEPS)
    rng = jax.random.PRNGKey(1)
    out = engine.run_scripted_collection(env, len(seeds), rng,
                                         episode_len=EXPERT_STEPS,
                                         episode_seeds=seeds)
    # the spawns, from the reset keys run_scripted_collection derives
    keys = engine._reset_rngs(jax.random.split(rng)[0], jnp.asarray(seeds))
    states, _ = jax.jit(jax.vmap(env.reset))(keys)
    q = np.asarray(states.bodies.quat[:, J.OBJ])
    success = np.asarray(out["success"])
    print(f"{name} seeds {seeds[0]}-{seeds[-1]}: success "
          f"{success.any(1).astype(int).tolist()}", flush=True)
    return {"obj_xy": np.asarray(states.bodies.pos[:, J.OBJ, :2]),
            "obj_yaw": 2 * np.arctan2(q[:, 3], q[:, 0]),
            "success": success, "seeds": np.asarray(seeds)}


def expert_success(ranges=None) -> dict:
    """``ranges``: ``{name: (lo, hi)}``, the seeds of each expert to run;
    by default ``EXPERT_EPISODES``' seeds from 0."""
    ranges = ranges or {name: (0, n) for name, n in EXPERT_EPISODES.items()}
    jobs = [(name, list(range(first, min(first + N_ENVS, hi))))
            for name, (lo, hi) in ranges.items()
            for first in range(lo, hi, N_ENVS)]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        parts = pool.map(_expert_batch, jobs)
    out = {}
    for name in ranges:
        mine = [p for (n, _), p in zip(jobs, parts) if n == name]
        for k in mine[0]:
            out[f"{name}_expert_{k}"] = np.concatenate([p[k] for p in mine])
        won = out[f"{name}_expert_success"].any(1)
        print(f"{name} expert over {len(won)} episodes x {EXPERT_STEPS} "
              f"steps: {won.sum()} succeed ({won.mean():.3f})", flush=True)
    return out


def merge(parts, out_path) -> None:
    """Join fixtures that ``--seeds`` wrote into one, ordered by seed."""
    loaded = [dict(np.load(p)) for p in parts]
    out = {}
    for k in loaded[0]:
        out[k] = np.concatenate([d[k] for d in loaded])
    for k in [k for k in out if k.endswith("_expert_seeds")]:
        name = k[:-len("_expert_seeds")]
        order = np.argsort(out[k], kind="stable")
        assert len(np.unique(out[k])) == len(order), "a seed twice"
        for key in [key for key in out if key.startswith(f"{name}_expert_")]:
            out[key] = out[key][order]
        won = out[f"{name}_expert_success"].any(1)
        print(f"{name}: seeds {out[k].min()}-{out[k].max()}, "
              f"{won.sum()} of {len(won)} succeed", flush=True)
    np.savez_compressed(out_path, **out)
    print(f"wrote {out_path}")


def contact_step() -> dict:
    """One JAX control step of ``CanPhysicsEnv`` from perturbed contact
    states the port's expert reaches (see the module's docstring)."""
    import torch

    from latent_diffusion_planning_tpu_torch.envs import (
        pick_place_physics as P)
    env, n = P.CanPhysicsEnv(render_images=False), N_ENVS
    s = env.reset_state(n, torch.Generator().manual_seed(5))
    snaps = []
    for t in range(121):
        if t in (15, 20, 25, 30, 40, 60, 90, 120):
            snaps.append(s)
        s = env.transition(s, env.scripted_action(s))[0]
    s = s.map(lambda *xs: torch.cat(xs), *snaps)
    m = s.qpos.shape[0]
    rng = np.random.default_rng(0)
    noise = lambda sd: rng.normal(0, sd, (m, 3)).astype(np.float32)
    rec = {k: getattr(s.bodies, k).numpy().copy()
           for k in ("pos", "quat", "linvel", "angvel")}
    rec["pos"][:, J.OBJ] += noise(0.003)
    rec["linvel"][:, J.OBJ] += noise(0.1)
    rec["angvel"][:, J.OBJ] += noise(1.0)
    rec.update(qpos=s.qpos.numpy(), eef_target=s.eef_target.numpy(),
               gripper=s.gripper.numpy(), t=s.t.numpy(),
               action=rng.uniform(-1, 1, (m, 7)).astype(np.float32))
    jenv = J.CanPhysicsEnv(render_images=False)
    states = J.PickPlacePhysState(
        bodies=J.ph.RigidBody(**{k: jnp.asarray(rec[k]) for k in
                                 ("pos", "quat", "linvel", "angvel")}),
        qpos=jnp.asarray(rec["qpos"]), eef_target=jnp.asarray(
            rec["eef_target"]), gripper=jnp.asarray(rec["gripper"]),
        t=jnp.asarray(rec["t"]))

    def step(state, action):
        new, _, r, ok = jenv.step(state, action)
        return new, r, ok, jenv.holding(new)
    new, r, ok, held = jax.jit(jax.vmap(step))(states,
                                               jnp.asarray(rec["action"]))
    rec.update({f"next_{k}": getattr(new.bodies, k)
                for k in ("pos", "quat", "linvel", "angvel")})
    rec.update(next_qpos=new.qpos, reward=r, success=ok, holding=held)
    return {k: np.asarray(v) for k, v in rec.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--experts", action="store_true")
    ap.add_argument("--env", choices=tuple(EXPERT_EPISODES),
                    help="with --seeds: the one expert to run")
    ap.add_argument("--seeds", type=int, nargs=2, metavar=("LO", "HI"),
                    help="with --experts and --env: run seeds LO..HI-1 and "
                         "write them to --out as a fixture of their own")
    ap.add_argument("--merge", nargs="+", metavar="PART",
                    help="join --seeds fixtures into --out")
    ap.add_argument("--contact-step", action="store_true",
                    help="write one Can contact step to --out")
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures"
                                         / "pick_place_golden.npz"))
    args = ap.parse_args()
    if args.merge:
        merge(args.merge, args.out)
        return
    if args.contact_step:
        np.savez_compressed(args.out, **contact_step())
        print(f"wrote {args.out}")
        return
    if args.experts and args.seeds:
        if not args.env:
            ap.error("--seeds needs --env")
        out = expert_success({args.env: tuple(args.seeds)})
        np.savez_compressed(args.out, **out)
        print(f"wrote {args.out}")
        return
    if args.experts:
        # merged into the fixture beside what it holds
        out = {k: v for k, v in np.load(args.out).items()
               if "_expert_" not in k}
        out.update(expert_success())
        np.savez_compressed(args.out, **out)
        print(f"added the experts' success to {args.out}")
        return
    out = {}
    for name in ("CanPhysicsEnv", "SquarePhysicsEnv"):
        out.update(record_physics(name, args.steps))
    for name in ("CanEnv", "SquareEnv"):
        out.update(record_kinematic(name, args.steps))
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays")


if __name__ == "__main__":
    main()
