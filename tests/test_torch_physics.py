"""The port's rotations, kinematics, physics engine and Lift physics env vs
the JAX package's.

Seeded numpy inputs go through the JAX function (one env, un-jitted or
``vmap``ped) and its batched counterpart in the port. Both sides are fp32 on
the CPU; sums are taken in another order, so single functions are held at
1e-6 (rotations) and 1e-5 (kinematics, contacts, forces relative to the
force scale, ten substeps). The whole env is held to the recorded
trajectory ``tests/fixtures/replay_golden.npz`` at the JAX package's own
tolerances (``tests/test_replay_regression.py``: eef 1e-4, cube 1e-3,
reward 1e-3).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.envs import lift_physics as jlp
from latent_diffusion_planning_tpu.envs import physics as jph
from latent_diffusion_planning_tpu.envs import robosuite_arm as jra
from latent_diffusion_planning_tpu.envs.physics import kinematics as JK
from latent_diffusion_planning_tpu.ops import rotations as jrot
from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
from latent_diffusion_planning_tpu_torch.envs import physics as ph
from latent_diffusion_planning_tpu_torch.envs import robosuite_arm as ra
from latent_diffusion_planning_tpu_torch.envs.physics import kinematics as K
from latent_diffusion_planning_tpu_torch.ops import rotations as rot
from torch_thread import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).parent / "fixtures"
T = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _quats(rng, *shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "quat_normalize", "quat_mul", "quat_conj", "quat_rotate",
    "quat_to_matrix", "quat_from_unit_axis", "axis_angle_to_quat",
    "quat_integrate", "quat_wxyz_to_xyzw", "quat_identity"])
def test_rotation_function_matches_jax(name):
    rng = np.random.default_rng(0)
    q, q2 = _quats(rng, 5, 3), _quats(rng, 5, 3)
    v = rng.normal(size=(5, 3, 3)).astype(np.float32)
    v[0, 0] = 0.0                       # the zero rotation / zero vector
    axis = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    axis[0, 0] = [0.0, 0.0, 1.0]
    angle = rng.uniform(-3, 3, size=(5, 3)).astype(np.float32)
    args = {
        "quat_normalize": (q * 3.0,), "quat_mul": (q, q2), "quat_conj": (q,),
        "quat_rotate": (q, v), "quat_to_matrix": (q * 1.5,),
        "quat_from_unit_axis": (axis, angle), "axis_angle_to_quat": (v,),
        "quat_integrate": (q, v), "quat_wxyz_to_xyzw": (q,),
        "quat_identity": (),
    }[name]
    extra = (0.01,) if name == "quat_integrate" else ()
    ref = getattr(jrot, name)(*(jnp.asarray(a) for a in args), *extra)
    if name == "quat_identity":
        extra = ("cpu",)        # the port's takes the device; none to default to
    got = getattr(rot, name)(*(T(a) for a in args), *extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_rotate_by_matrix_matches_quat_rotate():
    rng = np.random.default_rng(1)
    q, v = T(_quats(rng, 7)), T(rng.normal(size=(7, 3)))
    m = rot.quat_to_matrix(q)
    np.testing.assert_allclose(rot.rotate(m, v), rot.quat_rotate(q, v),
                               atol=1e-6)
    np.testing.assert_allclose(rot.rotate_t(m, v),
                               rot.quat_rotate(rot.quat_conj(q), v), atol=1e-6)


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------

def _joint_vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jra.PANDA_LO), np.asarray(jra.PANDA_HI)
    return (lo + rng.uniform(0.05, 0.95, size=(n, 7)) * (hi - lo)).astype(
        np.float32)


def test_panda_constants_match_jax():
    jc, c = jra.panda_chain(), ra.panda_chain()
    for f in jc._fields:
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for name in ("PANDA_LO", "PANDA_HI", "PANDA_HOME"):
        np.testing.assert_array_equal(getattr(ra, name).numpy(),
                                      np.asarray(getattr(jra, name)))
    assert ra.MAX_JOINT_DELTA == jra.MAX_JOINT_DELTA


@pytest.mark.parametrize("name", ["fk", "geometric_jacobian", "dls_ik_step",
                                  "arm_track", "servo_step"])
def test_kinematics_function_matches_jax(name):
    q = _joint_vectors(6)
    rng = np.random.default_rng(2)
    jc, c = jlp.PANDA_CHAIN, lp.PANDA_CHAIN
    target = (np.asarray([0.0, 0.0, 1.0]) + rng.uniform(
        -0.2, 0.2, size=(6, 3))).astype(np.float32)
    if name == "fk":
        ref = jax.vmap(lambda x: JK.fk(jc, x))(jnp.asarray(q))
        got = K.fk(c, T(q))
    elif name == "geometric_jacobian":
        ref = (jax.vmap(lambda x: JK.geometric_jacobian(jc, x))(jnp.asarray(q)),)
        got = (K.geometric_jacobian(c, T(q)),)
    elif name == "dls_ik_step":
        ref = (jax.vmap(lambda x, t: JK.dls_ik_step(
            jc, x, t, damping=0.1, lo=jra.PANDA_LO, hi=jra.PANDA_HI))(
                jnp.asarray(q), jnp.asarray(target)),)
        got = (K.dls_ik_step(c, T(q), T(target), damping=0.1, lo=ra.PANDA_LO,
                             hi=ra.PANDA_HI),)
    elif name == "arm_track":
        ref = (jax.vmap(lambda x, t: jra.arm_track(jc, x, t))(
            jnp.asarray(q), jnp.asarray(target)),)
        got = (ra.arm_track(c, T(q), T(target)),)
    else:
        goal = _joint_vectors(6, seed=3)
        ref = (JK.servo_step(jnp.asarray(q), jnp.asarray(goal), 0.1,
                             jra.PANDA_LO, jra.PANDA_HI),)
        got = (K.servo_step(T(q), T(goal), 0.1, ra.PANDA_LO, ra.PANDA_HI),)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_solve3_matches_a_pivoting_solve():
    rng = np.random.default_rng(4)
    J = rng.normal(size=(9, 3, 7)).astype(np.float32)
    A = J @ J.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(9, 3)).astype(np.float32)
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])
    np.testing.assert_allclose(K.solve3(T(A), T(b)).numpy(), ref[..., 0],
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# contacts, forces, substeps on the Lift world
# ---------------------------------------------------------------------------

def _cases():
    """Cube + two pads: resting flat, tilted into the table, squeezed
    between the pads in the air, pads overlapping each other."""
    z = lp.TABLE_Z + lp.CUBE_HALF
    far = [[0.3, 0.3, 1.2], [0.4, 0.3, 1.2]]
    gap = lp.FINGER_MIN_HALFGAP
    pos = np.asarray([
        [[0.0, 0.0, z - 1e-4]] + far,
        [[0.02, -0.03, z + 0.004]] + far,
        [[0.0, 0.0, 1.0], [-gap, 0.0, 1.0], [gap, 0.0, 1.0]],
        [[0.0, 0.0, z - 3e-4], [0.1, 0.0, 0.805], [0.11, 0.0, 0.81]],
    ], np.float32)
    rng = np.random.default_rng(5)
    quat = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (4, 3, 1))
    quat[1, 0] = _quats(np.random.default_rng(6))           # tilted cube
    quat[1, 0] = quat[1, 0] * [1.0, 0.15, 0.15, 0.3]
    quat[1, 0] /= np.linalg.norm(quat[1, 0])
    linvel = rng.normal(size=(4, 3, 3)).astype(np.float32) * 0.05
    angvel = rng.normal(size=(4, 3, 3)).astype(np.float32) * 0.3
    linvel[0] = 0.0
    angvel[0] = 0.0
    return pos, quat, linvel, angvel


def _both_bodies():
    pos, quat, linvel, angvel = _cases()
    jbodies = [jph.RigidBody(pos=jnp.asarray(pos[i]), quat=jnp.asarray(quat[i]),
                             linvel=jnp.asarray(linvel[i]),
                             angvel=jnp.asarray(angvel[i])) for i in range(4)]
    body = ph.RigidBody(T(pos), T(quat), T(linvel), T(angvel))
    return jbodies, body


def test_contact_plan_matches_jax_pair_loop():
    jworld, world = jlp._make_world(), lp._make_world()
    jbodies, _ = _both_bodies()
    ref = jph.generate_contacts(jworld, jbodies[0])
    plan = world.plan
    assert plan.n_reference == ref.depth.shape[0] == 27
    idx = plan.reference_index
    np.testing.assert_array_equal(np.asarray(ref.body_a)[idx], plan.body_a)
    np.testing.assert_array_equal(np.asarray(ref.body_b)[idx], plan.body_b)
    # the rows left out are the JAX engine's padding: masked sphere points
    left_out = np.setdiff1d(np.arange(27), idx)
    assert (np.asarray(ref.depth)[left_out] == -1.0).all()


def test_generate_contacts_matches_jax():
    jworld, world = jlp._make_world(), lp._make_world()
    jbodies, body = _both_bodies()
    got = ph.generate_contacts(world, body)
    idx = world.plan.reference_index
    n_active = 0
    for i, jb in enumerate(jbodies):
        ref = jph.generate_contacts(jworld, jb)
        np.testing.assert_allclose(got.depth[i].numpy(),
                                   np.asarray(ref.depth)[idx], atol=1e-6)
        active = np.asarray(ref.depth)[idx] > -0.5
        n_active += int((np.asarray(ref.depth)[idx] > 0).sum())
        for f in ("point", "normal"):
            np.testing.assert_allclose(
                getattr(got, f)[i].numpy()[active],
                np.asarray(getattr(ref, f))[idx][active], atol=1e-5,
                err_msg=f"{f}, case {i}")
    assert n_active >= 8        # the cases do touch


def test_contact_forces_match_jax():
    jworld, world = jlp._make_world(), lp._make_world()
    jbodies, body = _both_bodies()
    params = ph.PhysicsParams(mu=1.5, kt=2000.0)
    jparams = jph.PhysicsParams(mu=1.5, kt=2000.0)
    force, torque = ph.contact_forces(
        world, body, ph.generate_contacts(world, body), params)
    for i, jb in enumerate(jbodies):
        jf, jt = jph.contact_forces(jworld, jb,
                                    jph.generate_contacts(jworld, jb), jparams)
        scale = max(float(np.abs(jf).max()), 1.0)
        assert float(np.abs(jf).max()) > 0.1, f"case {i} has no contact force"
        np.testing.assert_allclose(force[i].numpy(), np.asarray(jf),
                                   atol=1e-5 * scale, err_msg=f"case {i}")
        np.testing.assert_allclose(torque[i].numpy(), np.asarray(jt),
                                   atol=1e-5 * scale, err_msg=f"case {i}")


def test_free_body_step_ten_substeps_match_jax():
    jworld, world = jlp._make_world(), lp._make_world()
    jbodies, body = _both_bodies()
    params = ph.PhysicsParams(mu=1.5, kt=2000.0)
    jparams = jph.PhysicsParams(mu=1.5, kt=2000.0)
    jstep = jax.jit(lambda b: jph.free_body_step(jworld, b, jparams))
    for _ in range(10):
        body = ph.free_body_step(world, body, params)
        jbodies = [jstep(b) for b in jbodies]
    for i, jb in enumerate(jbodies):
        for f in ("pos", "quat", "linvel", "angvel"):
            ref = np.asarray(getattr(jb, f))
            # 1e-5 of the field's scale (a struck cube spins at 17 rad/s)
            np.testing.assert_allclose(
                getattr(body, f)[i].numpy(), ref,
                atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                err_msg=f"{f}, case {i}")


def test_argmin_ties_take_the_first_axis():
    """A sphere at the exact centre of a cube: all three face penetrations
    are equal; the JAX engine's argmin takes axis 0, and so must the port
    (on the card too: ``torch.argmin`` returns the first minimal index)."""
    geoms = [("box", [0.02] * 3, 0), ("sphere", 0.008, 1)]
    mk = lambda m: m.build_geoms([
        m.make_box_geom(geoms[0][1], body_id=0),
        m.make_sphere_geom(geoms[1][1], body_id=1)])
    jworld = jph.World.create([1.0, 1.0], [[1e-3] * 3] * 2, mk(jph), plane_z=0.0)
    world = ph.World.create([1.0, 1.0], [[1e-3] * 3] * 2, mk(ph), plane_z=0.0)
    pos = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    ref = jph.generate_contacts(jworld, jph.RigidBody.create(pos))
    got = ph.generate_contacts(world, ph.RigidBody.create(pos))
    idx = world.plan.reference_index
    np.testing.assert_allclose(got.normal[0].numpy(),
                               np.asarray(ref.normal)[idx], atol=1e-6)
    np.testing.assert_allclose(got.depth[0].numpy(),
                               np.asarray(ref.depth)[idx], atol=1e-6)
    # sign(0) = 0: the pushed-out normal of a centred sphere is zero
    assert float(got.normal[0, -1].abs().max()) == 0.0
    assert bool(ph.pair_in_contact(got, 0, 1)[0])
    assert not bool(ph.pair_in_contact(got, 0, -1)[0])


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------

def _jax_draws(key):
    """What ``LiftPhysicsEnv.reset(key)`` of the JAX package draws."""
    xy_rng, yaw_rng = jax.random.split(key)
    xy = jax.random.uniform(xy_rng, (2,), minval=-0.1, maxval=0.1)
    yaw = jax.random.uniform(yaw_rng, (), minval=-jnp.pi / 6, maxval=jnp.pi / 6)
    return np.asarray(xy), np.asarray(yaw)


def _reset_like_jax(env, keys):
    draws = [_jax_draws(k) for k in keys]
    return env.reset_state(
        len(keys), torch.Generator().manual_seed(0),
        cube_xy=T(np.stack([d[0] for d in draws])),
        cube_yaw=T(np.stack([d[1] for d in draws])))


def test_reset_matches_jax():
    """The settled home pose (8 ``arm_track`` iterations), pads and cube."""
    key = jax.random.PRNGKey(5)
    jstate, jobs = jlp.LiftPhysicsEnv(render_images=False).reset(key)
    env = lp.LiftPhysicsEnv(render_images=False)
    state = _reset_like_jax(env, [key])
    obs = env.obs(state)
    np.testing.assert_allclose(state.qpos[0].numpy(), np.asarray(jstate.qpos),
                               atol=1e-5)
    for f in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(getattr(state.bodies, f)[0].numpy(),
                                   np.asarray(getattr(jstate.bodies, f)),
                                   atol=1e-5, err_msg=f)
    assert set(obs) == set(jobs)
    for k in jobs:
        np.testing.assert_allclose(obs[k][0].numpy(), np.asarray(jobs[k]),
                                   atol=1e-5, err_msg=k)


def test_lift_physics_replay_matches_golden():
    golden = np.load(FIXTURES / "replay_golden.npz")
    env = lp.LiftPhysicsEnv(render_images=False, episode_len=40)
    state = _reset_like_jax(env, [jax.random.PRNGKey(5)])
    eef, cube, rewards = [], [], []
    for a in golden["lift_actions"]:
        state, obs, r, _ = env.step(state, T(a)[None])
        eef.append(obs["robot0_eef_pos"][0].numpy())
        cube.append(state.bodies.pos[0, 0].numpy())
        rewards.append(float(r[0]))
    np.testing.assert_allclose(np.stack(eef), golden["lift_eef"], atol=1e-4)
    np.testing.assert_allclose(np.stack(cube), golden["lift_cube"], atol=1e-3)
    np.testing.assert_allclose(np.asarray(rewards), golden["lift_rewards"],
                               atol=1e-3)


def test_scripted_expert_lifts_six_of_six():
    env = lp.LiftPhysicsEnv(render_images=False, episode_len=80)
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    state = _reset_like_jax(env, list(keys))
    success = torch.zeros(6, dtype=torch.bool)
    for _ in range(80):
        state, _, ok = env.transition(state, env.scripted_action(state))
        success |= ok
    assert success.all(), f"physics expert lifted {int(success.sum())} of 6"
    for leaf in (state.bodies.pos, state.bodies.quat, state.qpos):
        assert torch.isfinite(leaf).all()


def test_batch_of_four_equals_four_single_envs():
    env = lp.LiftPhysicsEnv(render_images=False)
    keys = list(jax.random.split(jax.random.PRNGKey(2), 4))
    batch = _reset_like_jax(env, keys)
    singles = [_reset_like_jax(env, [k]) for k in keys]
    rng = np.random.default_rng(7)
    acts = T(rng.uniform(-1, 1, size=(12, 4, 7)))
    acts[:, :, 2] = -acts[:, :, 2].abs()          # go down to the cube
    for a in acts:
        batch = env.transition(batch, a)[0]
        singles = [env.transition(s, a[i:i + 1])[0]
                   for i, s in enumerate(singles)]
    flat = lambda s: torch.cat([s.bodies.pos.flatten(1), s.bodies.quat.flatten(1),
                                s.bodies.linvel.flatten(1), s.qpos,
                                s.eef_target, s.gripper[:, None]], -1)
    np.testing.assert_allclose(
        flat(batch).numpy(), torch.cat([flat(s) for s in singles]).numpy(),
        atol=1e-6)


def test_reset_takes_its_device_from_the_generator():
    """No entry point of the env has a device of its own to default to the
    CPU with: states lie on the generator's device, observations and
    transitions on the state's."""
    import dataclasses
    import inspect
    env = lp.LiftPhysicsEnv(image_size=8)
    for fn in (env.reset, env.reset_state, env.transition, env.obs,
               env.scripted_action):
        assert "device" not in inspect.signature(fn).parameters
    gen = torch.Generator(device="cpu").manual_seed(3)
    state, obs = env.reset(3, gen)
    leaves = []
    state.map(lambda x: leaves.append(x.device) or x)
    assert set(leaves) == {gen.device}
    assert all(v.device == gen.device for v in obs.values())
    with pytest.raises(AttributeError):
        env.reset_state(3, None)
    with pytest.raises(TypeError):
        rot.quat_identity()


def test_state_map_reaches_every_leaf():
    env = lp.LiftPhysicsEnv(render_images=False)
    state = env.reset_state(3, torch.Generator().manual_seed(1))
    seen = []
    state.map(lambda x: seen.append(x.shape) or x)
    assert len(seen) == 9
    doubled = state.map(lambda a, b: a + b, state)
    assert torch.equal(doubled.bodies.pos, 2 * state.bodies.pos)
    assert torch.equal(doubled.qpos, 2 * state.qpos)


def test_general_world_matches_jax():
    """A world the Lift task does not have: a static box of the world (body
    −1, with an offset), a dynamic box resting on it corner-in-face both
    ways, a dynamic sphere whose geom sits off its body's origin and touches
    both boxes. Contacts, forces and ten substeps against the JAX engine:
    the static-geom poses, the box-box corner contacts and the sphere
    against a static box."""
    def geoms(m):
        return m.build_geoms([
            m.make_box_geom([0.03, 0.04, 0.05], body_id=0),
            m.make_sphere_geom(0.02, body_id=1, offset=(0.0, 0.01, 0.0)),
            # static geoms go last: the JAX pair loop starts from the
            # dynamic side and pairs boxes only where a < b
            m.make_box_geom([0.2, 0.2, 0.05], body_id=-1, offset=(0, 0, 0.05)),
        ])
    mass, inertia = [0.2, 0.1], [[2e-4] * 3, [1e-4] * 3]
    jworld = jph.World.create(mass, inertia, geoms(jph), plane_z=0.0)
    world = ph.World.create(mass, inertia, geoms(ph), plane_z=0.0)
    rng = np.random.default_rng(8)
    q = _quats(rng) * [1.0, 0.1, 0.1, 0.2]
    q = (q / np.linalg.norm(q)).astype(np.float32)
    pos = np.asarray([[0.0, 0.0, 0.1 + 0.047], [0.045, 0.0, 0.1 + 0.018]],
                     np.float32)
    quat = np.stack([q, np.asarray([1.0, 0, 0, 0], np.float32)])
    linvel = (rng.normal(size=(2, 3)) * 0.05).astype(np.float32)
    angvel = (rng.normal(size=(2, 3)) * 0.3).astype(np.float32)
    jbody = jph.RigidBody(*(jnp.asarray(a) for a in (pos, quat, linvel, angvel)))
    body = ph.RigidBody(*(T(a)[None] for a in (pos, quat, linvel, angvel)))
    plan = world.plan
    assert plan.box_box == [(0, 2), (2, 0)] and plan.sphere_box == [(1, 0), (1, 2)]

    ref = jph.generate_contacts(jworld, jbody)
    got = ph.generate_contacts(world, body)
    idx = plan.reference_index
    assert plan.n_reference == ref.depth.shape[0]
    np.testing.assert_array_equal(np.asarray(ref.body_a)[idx], plan.body_a)
    np.testing.assert_array_equal(np.asarray(ref.body_b)[idx], plan.body_b)
    depth = np.asarray(ref.depth)[idx]
    np.testing.assert_allclose(got.depth[0].numpy(), depth, atol=1e-6)
    touching = depth > 0
    kinds = {(a, b) for a, b, on in zip(plan.body_a, plan.body_b, touching) if on}
    assert {(0, -1), (1, -1), (1, 0)} <= kinds, kinds
    for f in ("point", "normal"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy()[touching],
                                   np.asarray(getattr(ref, f))[idx][touching],
                                   atol=1e-5, err_msg=f)
    for i, j in ((0, -1), (1, 0), (0, 1), (1, -1)):
        assert bool(ph.pair_in_contact(got, i, j)[0]) == bool(
            jph.pair_in_contact(ref, i, j))

    params, jparams = ph.PhysicsParams(), jph.PhysicsParams()
    force, torque = ph.contact_forces(world, body, got, params)
    jf, jt = jph.contact_forces(jworld, jbody, ref, jparams)
    scale = max(float(np.abs(jf).max()), 1.0)
    np.testing.assert_allclose(force[0].numpy(), np.asarray(jf),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(torque[0].numpy(), np.asarray(jt),
                               atol=1e-5 * scale)
    jstep = jax.jit(lambda b: jph.free_body_step(jworld, b, jparams))
    for _ in range(10):
        body, jbody = ph.free_body_step(world, body, params), jstep(jbody)
    for f in ("pos", "quat", "linvel", "angvel"):
        ref_f = np.asarray(getattr(jbody, f))
        np.testing.assert_allclose(
            getattr(body, f)[0].numpy(), ref_f,
            atol=1e-5 * max(1.0, float(np.abs(ref_f).max())), err_msg=f)
