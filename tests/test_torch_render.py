"""The port's renderer and kinematic Lift env vs the JAX package.

Renders are held at the JAX package's own renderer bar
(``tests/test_pallas_raycast.py``): more than 98% of pixels within 2.0 of
255, the rest being silhouette pixels whose nearest-hit ties resolve
differently in float. Env states and low-dim observations are fp32
arithmetic on the same inputs: atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.envs import lift as jlift
from latent_diffusion_planning_tpu.envs import mjcf
from latent_diffusion_planning_tpu.ops import render as JR
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.ops import render as R
from latent_diffusion_planning_tpu_torch.ops.kernels import raycast
from torch_thread import one_torch_thread  # noqa: F401

STATE_ATOL = 1e-5


def _frac_close(a, b):
    return (np.abs(np.asarray(a) - np.asarray(b)).max(-1) < 2.0).mean()


def _jax_states(n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    states, _ = jax.vmap(jlift.LiftEnv(render_images=False).reset)(keys)
    return states


def _to_torch(states) -> lift.LiftState:
    return lift.LiftState(**{k: torch.from_numpy(np.array(getattr(states, k)))
                             for k in ("eef_pos", "gripper", "cube_pos",
                                       "cube_yaw", "grasped", "t")})


def test_lift_renders_match_jax():
    """LiftEnv scenes through the twin of the ray-cast kernel (what a CPU
    tensor runs) vs the JAX renderer; grasp and lift states included."""
    states = _jax_states(4)
    # move some envs: lift the cube with the eef, close the gripper
    states = states.replace(
        eef_pos=states.eef_pos.at[2].set(states.cube_pos[2]),
        cube_pos=states.cube_pos.at[2:, 2].add(0.1),
        gripper=states.gripper.at[1].set(0.2))
    ref = jax.vmap(jlift.LiftEnv().render)(states)
    got = lift.LiftEnv().render(_to_torch(states))
    assert got.shape == (4, 64, 64, 3)
    assert _frac_close(got.numpy(), ref) > 0.98


def _convex_scenes():
    dirs = mjcf.kdop_directions(26)
    verts = np.asarray([[0.04, 0, 0], [-0.04, 0, 0], [0, 0.04, 0],
                        [0, -0.04, 0], [0, 0, 0.05], [0, 0, -0.05]],
                       np.float32)
    hull = np.asarray(mjcf.fit_kdop(verts, dirs), np.float32)
    pad = np.zeros((26, 4), np.float32)
    pad[:, 3] = 1.0
    jscene = JR.Scene(
        pos=jnp.asarray([[0.05, 0.0, 0.88], [0.0, 0.1, 0.9]]),
        rot=jnp.stack([JR.euler_z(jnp.asarray(0.4)), jnp.eye(3)]),
        size=jnp.asarray([[0.04, 0.04, 0.05], [0.03, 0.0, 0.0]]),
        color=jnp.asarray([[0.85, 0.1, 0.1], [0.2, 0.4, 0.8]]),
        kind=jnp.asarray([2, 1], jnp.int32),
        plane_z=jnp.asarray(0.8, jnp.float32),
        planes=jnp.stack([jnp.asarray(hull), jnp.asarray(pad)]))
    t = lambda a, dt=torch.float32: torch.from_numpy(np.array(a)).to(dt)[None]
    scene = R.Scene(pos=t(jscene.pos), rot=t(jscene.rot), size=t(jscene.size),
                    color=t(jscene.color), kind=t(jscene.kind, torch.int32),
                    plane_z=t(jscene.plane_z),
                    plane_color=t(jscene.plane_color),
                    planes=t(jscene.planes))
    return jscene, scene


def test_convex_render_matches_jax():
    jscene, scene = _convex_scenes()
    jcam = JR.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    cam = R.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    ref = JR.render(jscene, jcam, 32, 64)
    got = raycast.render_batch_cuda(scene, cam, 32, 64, n_convex=1)
    assert got.shape == (1, 32, 64, 3)
    assert _frac_close(got[0].numpy(), ref) > 0.98


def test_camera_rays_match_jax():
    jcam = JR.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    cam = R.look_at(pos=(0.55, 0.0, 1.25), lookat=(0.0, 0.0, 0.85))
    np.testing.assert_allclose(R.camera_rays(cam, 16, 24).numpy(),
                               np.asarray(JR._camera_rays(jcam, 16, 24)),
                               atol=1e-6)


def test_lift_env_steps_match_jax():
    """reset_to, then 50 steps of one numpy action sequence per env, in both
    envs: states, rewards, success and low-dim obs agree at every step."""
    n, steps = 6, 50
    states = _jax_states(n, seed=1)
    jenv = jlift.LiftEnv(render_images=False)
    env = lift.LiftEnv(render_images=False)
    tstate, tobs = env.reset_to(_to_torch(states))
    _, jobs = jax.vmap(jenv.reset_to)(states)
    rng = np.random.default_rng(0)
    acts = rng.uniform(-1.2, 1.2, size=(steps, n, 7)).astype(np.float32)
    # a descend-and-close phase so grasps engage
    acts[10:25, :, :2] = 0.0
    acts[10:25, :, 2] = -1.0
    acts[18:, :, 6] = 1.0
    jstep = jax.jit(jax.vmap(jenv.step))
    for i in range(steps):
        for k in jobs:
            np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]),
                                       atol=STATE_ATOL, err_msg=f"{k} @ {i}")
        states, jobs, jr, js = jstep(states, jnp.asarray(acts[i]))
        tstate, tobs, r, s = env.step(tstate, torch.from_numpy(acts[i]))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=STATE_ATOL)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tstate.grasped.numpy(),
                                      np.asarray(states.grasped))
        np.testing.assert_allclose(tstate.cube_pos.numpy(),
                                   np.asarray(states.cube_pos),
                                   atol=STATE_ATOL)


def test_reset_draws_in_range():
    env = lift.LiftEnv(render_images=False)
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset(256, gen)
    xy = state.cube_pos[:, :2]
    assert float(xy.abs().max()) <= 0.1
    assert float(state.cube_yaw.abs().max()) <= np.pi / 6
    assert obs["object"].shape == (256, 10)
    assert not state.grasped.any()


def test_reset_takes_its_device_from_the_generator():
    """``reset`` and ``reset_state`` have no device of their own to default
    to the CPU with: every field of the state, and the observation, lies on
    the device of the generator the caller passes."""
    import inspect
    env = lift.LiftEnv(image_size=8, episode_len=4)
    for fn in (env.reset, env.reset_state):
        assert "device" not in inspect.signature(fn).parameters
    gen = torch.Generator(device="cpu").manual_seed(3)
    state, obs = env.reset(5, gen)
    for f in dataclasses.fields(state):
        assert getattr(state, f.name).device == gen.device, f.name
    assert all(v.device == gen.device for v in obs.values())
    again = env.reset_state(5, torch.Generator(device="cpu").manual_seed(3))
    assert torch.equal(again.cube_pos, state.cube_pos)
    with pytest.raises(AttributeError):
        env.reset_state(5, None)


# ---------------------------------------------------------------------------
# the physics Lift scene (6 prims: cube, two sphere pads, three rotated
# arm-link boxes) and the redesigned kernel's data path
# ---------------------------------------------------------------------------

from pathlib import Path

from latent_diffusion_planning_tpu.envs import lift_physics as jlp
from latent_diffusion_planning_tpu.ops.pallas import raycast as jraycast
from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp

FIXTURES = Path(__file__).parent / "fixtures"


def _jax_reset_draws(key):
    xy_rng, yaw_rng = jax.random.split(key)
    xy = jax.random.uniform(xy_rng, (2,), minval=-0.1, maxval=0.1)
    yaw = jax.random.uniform(yaw_rng, (), minval=-jnp.pi / 6, maxval=jnp.pi / 6)
    return (torch.from_numpy(np.array(xy))[None],
            torch.from_numpy(np.array(yaw))[None])


def _expert_states(key, grab):
    """The port's env from JAX's reset draws for ``key``, rolled with the
    scripted expert; the states after reset and after the steps in
    ``grab``."""
    env = lp.LiftPhysicsEnv(image_size=64, episode_len=40)
    xy, yaw = _jax_reset_draws(key)
    state = env.reset_state(1, torch.Generator().manual_seed(0), cube_xy=xy,
                            cube_yaw=yaw)
    states = [state]
    for t in range(max(grab) + 1):
        state = env.transition(state, env.scripted_action(state))[0]
        if t in grab:
            states.append(state)
    return env, states


def test_lift_physics_frames_match_golden():
    """Frames after reset and after steps 4, 9, 19 of the scripted expert
    from ``PRNGKey(3)``'s draws, at the JAX package's golden-render bar
    (``tests/test_render_golden.py``: mean < 1.0, max < 64)."""
    env, states = _expert_states(jax.random.PRNGKey(3), (4, 9, 19))
    frames = np.concatenate([env.render(s).numpy() for s in states])
    ref = np.load(FIXTURES / "render_golden.npz")["lift_frames"].astype(
        np.float32)
    diff = np.abs(frames - ref)
    assert diff.mean() < 1.0 and diff.max() < 64.0, (
        f"lift render drift: mean {diff.mean():.2f}, max {diff.max():.0f}")


def test_lift_physics_scene_matches_pallas_interpret():
    """The 6-prim scene through the kernel's twin vs the JAX package's
    Pallas kernel in interpret mode, on the same scene tensors."""
    env, states = _expert_states(jax.random.PRNGKey(4), (3, 8))
    scenes = [env.scene(s) for s in states]
    got = np.concatenate([env.render_scene(sc).numpy() for sc in scenes])
    cat = lambda f: jnp.asarray(np.concatenate(
        [getattr(sc, f).numpy() for sc in scenes]))
    assert tuple(scenes[0].kind[0].tolist()) == (0, 1, 1, 0, 0, 0)
    jscene = JR.Scene(pos=cat("pos"), rot=cat("rot"), size=cat("size"),
                      color=cat("color"), kind=cat("kind"),
                      plane_z=cat("plane_z"), plane_color=cat("plane_color"))
    jcam = JR.look_at(pos=env.camera.pos, lookat=env.camera.lookat)
    ref = jraycast.render_batch_pallas(jscene, jcam, 64, 64, interpret=True)
    assert got.shape == (3, 64, 64, 3)
    assert _frac_close(got, ref) > 0.999


def test_cached_constants_give_the_same_scene():
    """``LiftEnv`` keeps its device constants (work-space bounds, identity
    quat, scene sizes and colours) and ``light_rig`` per device; the scene
    and the low-dim observation equal what building every constant per call
    gave."""
    env = lift.LiftEnv(render_images=False)
    state = env.reset_state(5, torch.Generator().manual_seed(2))
    state.gripper = torch.linspace(0, 1, 5)
    scene = env.scene(state)
    n = 5
    grip_half = 0.008 + 0.006 * state.gripper
    const = lambda v: torch.tensor(v).expand(n, 3)
    want = dict(
        pos=torch.stack([state.cube_pos,
                         state.eef_pos + const([0.0, 0.0, 0.04]),
                         state.eef_pos], 1),
        rot=torch.stack([R.euler_z(state.cube_yaw),
                         torch.eye(3).expand(n, 3, 3),
                         torch.eye(3).expand(n, 3, 3)], 1),
        size=torch.stack([const([lift.CUBE_HALF] * 3),
                          const([0.015, 0.015, 0.035]),
                          torch.stack([grip_half,
                                       torch.full_like(grip_half, 0.02),
                                       torch.full_like(grip_half, 0.012)],
                                      -1)], 1),
        color=torch.tensor([[0.85, 0.1, 0.1], [0.65, 0.65, 0.7],
                            [0.2, 0.2, 0.25]]).expand(n, 3, 3),
        kind=torch.zeros((n, 3), dtype=torch.int32),
        plane_z=torch.full((n,), lift.TABLE_Z),
        plane_color=torch.tensor(R.PLANE_COLOR).expand(n, 3))
    for k, v in want.items():
        assert torch.equal(getattr(scene, k), v), k
    assert env.scene(state).color.data_ptr() == scene.color.data_ptr()
    obs = env.obs(state)
    assert torch.equal(obs["robot0_eef_quat"],
                       torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 4))
    act = torch.full((n, 7), 5.0)
    moved = env.transition(state, act)[0].eef_pos
    assert torch.equal(moved, torch.minimum(
        state.eef_pos + lift.EEF_SPEED, torch.tensor(lift.WORK_HI)))
    d = torch.tensor(R.LIGHT_DIRS)
    rig = torch.cat([d / torch.linalg.norm(d, dim=-1, keepdim=True),
                     torch.tensor(R.LIGHT_COLORS)[:, None]], -1)
    assert torch.equal(R.light_rig("cpu"), rig)
    assert R.light_rig("cpu") is R.light_rig("cpu")


# -- a NumPy transcription of csrc/raycast.cu: the per-block prologue (the
#    per-(env, prim) records it puts in shared memory, read through the env
#    strides the wrapper passes) and a pixel loop that uses nothing else

def _kernel_records(scene, cam, n_convex):
    args, _, (fields, _rays, _light) = raycast.launch_args(
        scene, cam, 8, 8, n_convex)
    N, P = scene.pos.shape[:2]
    inner = (P * 3, P * 9, P * 3, P * 3, P, None, 1, 3)
    read = []
    for (t, stride), width in zip(fields, inner):
        if t is None:
            read.append(None)
            continue
        width = width or t[0].numel()
        # the kernel reads base + env * stride + i for i < width
        read.append(torch.as_strided(t, (N, width), (stride, 1)).numpy())
    assert [a for a in args[1:20:2]] == [s for _, s in fields]
    pos, rot9, size, color, kind, planes, plane_z, plane_color = read
    pos, size, color = (a.reshape(N, P, 3) for a in (pos, size, color))
    Rm = rot9.reshape(N, P, 3, 3)
    o = _origins(cam, N, fields)
    rel = o[:, None] - pos
    ob = np.einsum("npij,npi->npj", Rm, rel)                  # Rᵀ (o - c)
    rec = np.zeros((N, P, raycast.REC_FLOATS), np.float32)
    rec[..., 0:9] = rot9.reshape(N, P, 9)
    rec[..., 9:12] = -size - ob
    rec[..., 12:15] = size - ob
    rec[..., 15:18] = rel
    rec[..., 18] = (rel * rel).sum(-1) - size[..., 0] ** 2
    rec[..., 19] = 1.0 / np.maximum(size[..., 0], 1e-9)
    rec[..., 20] = kind
    rec[..., 21:24] = color
    rec[..., 24] = (rel * rel).sum(-1) - 1.0201 * (size * size).sum(-1)
    hs = None
    if n_convex:
        K = scene.planes.shape[2]
        h = planes.reshape(N, P, K, 4)[:, :n_convex]
        hs = h.copy()
        hs[..., 3] = h[..., 3] - np.einsum("npkj,npj->npk", h[..., :3],
                                           ob[:, :n_convex])
    env_rec = np.concatenate([plane_z - o[:, 2:], plane_color], -1)
    return rec, hs, env_rec


def _origins(cam, N, fields):
    """(N, 3) camera origins as the kernel reads them: the launch's, or
    each env's from the ``cam_pos`` field (the marshalled pointer and
    stride)."""
    if isinstance(cam, R.CameraBatch):
        t, stride = fields[8]
        return torch.as_strided(t, (N, 3), (stride, 1)).numpy()
    assert fields[8:] == [(None, 0), (None, 0)]   # no per-env camera
    return np.broadcast_to(np.asarray(cam.pos, np.float32), (N, 3))


def _world_rays(cam, H, W, N):
    """(N, HW, 3) world directions: the shared table, or the camera-frame
    table rotated by each env's basis, as the kernel does it."""
    if isinstance(cam, R.CameraBatch):
        frame = R.camera_frame_rays(cam.fov_deg, H, W).reshape(-1, 3)
        d = torch.einsum("nij,xj->nxi", cam.basis, frame).numpy()
        return d.astype(np.float32), cam.pos.numpy()
    d = R.camera_rays(cam, H, W).reshape(-1, 3).numpy()
    return (np.broadcast_to(d, (N,) + d.shape),
            np.broadcast_to(np.asarray(cam.pos, np.float32), (N, 3)))


def _kernel_pixels(rec, hs, env_rec, cam, H, W, n_convex):
    BIG = np.float32(1e9)
    N, P = rec.shape[:2]
    d, o = _world_rays(cam, H, W, N)                          # (N, HW, 3)
    inv_dz = 1.0 / np.where(np.abs(d[..., 2]) < 1e-9, -1e-9, d[..., 2])
    t = env_rec[:, :1] * inv_dz
    best_t = np.where(t > 1e-4, t, BIG).astype(np.float32)    # (N, HW)
    best_p = np.full(best_t.shape, -1)
    bn = np.zeros(best_t.shape + (3,), np.float32)
    bn[..., 2] = 1.0
    for p in range(P):
        r = rec[:, p]
        Rm = r[:, 0:9].reshape(N, 3, 3)
        db = np.einsum("nij,nxi->nxj", Rm, d)                 # Rᵀ d
        if p < n_convex:
            h = hs[:, p]                                      # (N, K, 4)
            ndotd = np.einsum("nxj,nkj->nxk", db, h[..., :3])
            para = np.abs(ndotd) < 1e-9
            t_k = h[:, None, :, 3] / np.where(para, 1e-9, ndotd)
            entering = (ndotd < 0) & ~para
            t_ent = np.where(entering, t_k, -BIG)
            t_near = t_ent.max(-1)
            k_best = t_ent.argmax(-1)
            t_far = np.where(~entering & ~para, t_k, BIG).min(-1)
            t_near = np.where((para & (h[:, None, :, 3] < 0)).any(-1), BIG,
                              t_near)
            m = np.take_along_axis(h[:, None, :, :3].repeat(db.shape[1], 1),
                                   k_best[..., None, None].repeat(3, -1),
                                   2)[:, :, 0]
            m = np.where((t_ent.max(-1) > -BIG)[..., None], m, 0.0)
            normal = np.einsum("nij,nxj->nxi", Rm, m)
        elif r[0, 20] < 0.5:
            # the bounding-sphere test only skips work: a ray it rejects
            # must miss the box in the slab test below
            b_s = (r[:, None, 15:18] * d).sum(-1)
            c_b = r[:, None, 24]
            reject = ~((b_s * b_s - c_b >= 0) & ~((b_s > 0) & (c_b > 0)))
            safe = np.where(np.abs(db) < 1e-9,
                            np.where(db >= 0, 1e-9, -1e-9), db)
            inv = (1.0 / safe).astype(np.float32)
            t1, t2 = r[:, None, 9:12] * inv, r[:, None, 12:15] * inv
            tmin, tmax = np.minimum(t1, t2), np.maximum(t1, t2)
            t_near, t_far = tmin.max(-1), tmax.min(-1)
            ax = tmin.argmax(-1)
            sgn = -np.sign(np.take_along_axis(db, ax[..., None], -1))
            cols = Rm.transpose(0, 2, 1)                      # cols[n, ax]
            normal = sgn * cols[np.arange(N)[:, None], ax]
            slab_hit = (t_near <= t_far) & (t_far > 1e-4)
            assert not (reject & slab_hit).any()
            assert reject.mean() > 0.5       # and it does skip most rays
        else:
            oc = r[:, None, 15:18]
            b = (oc * d).sum(-1)
            disc = b * b - r[:, None, 18]
            sq = np.sqrt(np.maximum(disc, 0.0))
            t0, t1 = -b - sq, -b + sq
            t_s = np.where(t0 > 1e-4, t0, t1)
            t_near = np.where((disc > 0) & (t_s > 1e-4), t_s, BIG)
            t_far = BIG
            normal = (oc + d * t_near[..., None]) * r[:, None, 19:20]
        if p < n_convex or r[0, 20] < 0.5:
            hit = (t_near <= t_far) & (t_far > 1e-4)
            t_p = np.where(hit, np.where(t_near > 1e-4, t_near, t_far), BIG)
        else:
            t_p = t_near
        closer = t_p < best_t
        best_t = np.where(closer, t_p, best_t)
        best_p = np.where(closer, p, best_p)
        bn = np.where(closer[..., None], normal, bn)
    rig = R.light_rig("cpu").numpy()
    diffuse = (np.maximum(-(bn @ rig[:, :3].T), 0.0) * rig[:, 3]).sum(-1)
    shade = R.AMBIENT + diffuse
    px = o[:, None, 0] + d[..., 0] * best_t
    py = o[:, None, 1] + d[..., 1] * best_t
    s = np.floor(px * 5.0) + np.floor(py * 5.0)
    tint = 0.85 + 0.15 * (s - 2.0 * np.floor(s * 0.5))
    plane_rgb = env_rec[:, None, 1:4] * tint[..., None]
    prim_rgb = rec[np.arange(N)[:, None], np.maximum(best_p, 0), 21:24]
    col = np.where((best_p < 0)[..., None], plane_rgb, prim_rgb)
    sky = (0.6 + 0.4 * np.clip(d[..., 2], 0, 1))[..., None] * np.asarray(
        [0.7, 0.8, 0.9], np.float32)
    rgb = np.where((best_t < BIG * 0.5)[..., None], col * shade[..., None], sky)
    return (np.clip(rgb, 0, 1) * 255.0).reshape(N, H, W, 3)


@pytest.mark.parametrize("which", ["cube_box", "cube_kdop", "insertion"])
def test_kernel_prologue_transcription_per_env_camera(which):
    """With a camera per env (ALOHA's ``wrist64``): the kernel's records
    from each env's own origin, its rays the camera-frame table rotated by
    each env's basis, reproduce the twin (which sums the rays in the JAX
    package's order). The two ray tables differ by rounding (up to 2.4e-7),
    which moves about 0.03% of the pixels (at silhouettes and box edges,
    where a hit or its face turns on the last bits): 16 envs give the 99.9%
    bar enough pixels."""
    from latent_diffusion_planning_tpu_torch.envs import aloha_base as AB
    from latent_diffusion_planning_tpu_torch.envs import aloha_cube as AC
    from latent_diffusion_planning_tpu_torch.envs import aloha_insertion as AI
    H, W = 32, 48
    g = torch.Generator().manual_seed(2)
    if which == "insertion":
        env = AI.AlohaInsertionEnv(render_images=False)
    else:
        env = AC.AlohaTransferCubeEnv(render_images=False,
                                      mesh_mode=which.split("_")[1])
    state = env.reset_state(16, g)
    for _ in range(12):
        state, _, _ = env.transition(state, env.scripted_action(state))
    scene, cam = env.scene(state), AB.wrist64_camera(state.right)
    rec, hs, env_rec = _kernel_records(scene, cam, env.n_convex)
    got = _kernel_pixels(rec, hs, env_rec, cam, H, W, env.n_convex)
    ref = R.render_batch(scene, cam, H, W).numpy()
    assert _frac_close(got, ref) >= 0.999
    args = raycast.launch_args(scene, cam, H, W, env.n_convex)[0]
    assert args[17] == 3 and args[19] == 9        # origin and basis strides
    assert raycast.smem_bytes(13, 0, 0, 4, cam_per_env=True) == 4 * (
        4 * (13 * 28 + 20) + 12)


def _chip_smoke_convex_scenes(n):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convex_scenes(n, "cpu")


@pytest.mark.parametrize("which", ["lift", "physics", "convex"])
def test_kernel_prologue_transcription_matches_twin(which):
    """The records of the kernel's prologue, built in NumPy from the very
    pointers-and-strides marshalling the wrapper hands the kernel, and a
    pixel loop that reads only those records, reproduce the twin: a fault
    in the record layout, a stride or the folded constants shows here."""
    H, W = 32, 48
    if which == "lift":
        env = lift.LiftEnv(render_images=False)
        state = env.reset_state(3, torch.Generator().manual_seed(4))
        state.eef_pos = state.cube_pos + torch.tensor([[0.05, 0.02, 0.06]])
        scene, cam, n_convex = env.scene(state), env.camera, 0
    elif which == "physics":
        env, states = _expert_states(jax.random.PRNGKey(6), (5,))
        scene, cam, n_convex = env.scene(states[-1]), env.camera, 0
    else:
        scene = _chip_smoke_convex_scenes(3)
        cam, n_convex = R.look_at((0.55, 0.0, 1.25), (0.0, 0.0, 0.85)), 1
    rec, hs, env_rec = _kernel_records(scene, cam, n_convex)
    # broadcast fields go to the kernel with an env stride of 0, unpacked
    if which != "convex":
        args = raycast.launch_args(scene, cam, H, W, n_convex)[0]
        assert args[7] == 0                          # colour
        assert which == "lift" or args[9] == 0       # kind
    got = _kernel_pixels(rec, hs, env_rec, cam, H, W, n_convex)
    ref = R.render_batch(scene, cam, H, W).numpy()
    assert _frac_close(got, ref) >= 0.999
    assert raycast.smem_bytes(6, 0, 0, 4) == 4 * (4 * (6 * 28 + 4) + 12)
    assert raycast.default_envs_per_block(1024, 4096) == 4
    assert raycast.default_envs_per_block(64, 4096) == 1
