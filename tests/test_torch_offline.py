"""The port's offline modules against the JAX package's: the synthetic
dataset writers (``data/synthetic.py``), the MJCF importer
(``envs/mjcf.py``, on ``tests/test_mjcf.py``'s synthetic scene and a small
binary STL written here) and ALOHA-format HDF5 (``ingest.load_aloha`` and
``format: aloha`` in both data facades)."""

import struct

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.data import datasets as jdatasets
from latent_diffusion_planning_tpu.data import ingest as jingest
from latent_diffusion_planning_tpu.data import synthetic as jsynthetic
from latent_diffusion_planning_tpu.envs import mjcf as jmjcf
from latent_diffusion_planning_tpu.envs.physics import kinematics as JK
from latent_diffusion_planning_tpu_torch.data import datasets, ingest, synthetic
from latent_diffusion_planning_tpu_torch.envs import mjcf
from latent_diffusion_planning_tpu_torch.envs.physics import kinematics as K
from test_mjcf import SYNTH
from torch_thread import one_torch_thread  # noqa: F401

SHAPES = {"robot0_eef_pos": (3,), "agentview_image": (8, 8, 3)}
IMAGES = ("agentview_image",)


def _assert_welded_equal(got, want) -> None:
    """A port ``WeldedDemos`` (tensors) equals a JAX one (numpy)."""
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(got.demo_starts.numpy(), want.demo_starts)
    np.testing.assert_array_equal(got.demo_lengths.numpy(), want.demo_lengths)
    assert got.obs_keys == want.obs_keys
    assert got.env_meta == want.env_meta


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------

def test_synthetic_files_read_equal_to_jax(tmp_path):
    kw = dict(n_demos=3, demo_len=6, obs_shapes=SHAPES, seed=4,
              image_keys=IMAGES)
    mine = synthetic.write_robomimic_hdf5(tmp_path / "port.hdf5", **kw)
    theirs = jsynthetic.write_robomimic_hdf5(tmp_path / "jax.hdf5", **kw)
    lat_mine = synthetic.write_latent_hdf5(tmp_path / "port_lat.hdf5", mine,
                                           IMAGES, seed=2)
    lat_theirs = jsynthetic.write_latent_hdf5(tmp_path / "jax_lat.hdf5",
                                              theirs, IMAGES, seed=2)
    keys = ("robot0_eef_pos", "agentview_image", "latent_agentview_image")
    got = ingest.load_robomimic(str(mine), keys, latent_path=str(lat_mine))
    want = jingest.load_robomimic(str(theirs), keys,
                                  latent_path=str(lat_theirs))
    _assert_welded_equal(got, want)
    with h5py.File(mine) as a, h5py.File(theirs) as b:
        assert a["data"].attrs["env_args"] == b["data"].attrs["env_args"]
        assert a["data/demo_1"].attrs["num_samples"] == 6
    assert synthetic.synthetic_stats(SHAPES, ["latent_x"], IMAGES) == \
        jsynthetic.synthetic_stats(SHAPES, ["latent_x"], IMAGES)


def test_synthetic_npz_twin_reads_as_the_hdf5(tmp_path):
    kw = dict(n_demos=2, demo_len=5, obs_shapes=SHAPES, seed=1,
              image_keys=IMAGES)
    h5 = synthetic.write_robomimic_hdf5(tmp_path / "d.hdf5", **kw)
    npz = synthetic.write_robomimic_npz(tmp_path / "d.npz", **kw)
    keys = tuple(SHAPES)
    a = ingest.load_demos(str(h5), keys)
    b = ingest.load_demos(str(npz), keys)
    for k in a.arrays:
        assert torch.equal(a.arrays[k], b.arrays[k]), k
    assert torch.equal(a.demo_lengths, b.demo_lengths)
    assert a.env_meta == b.env_meta


# ---------------------------------------------------------------------------
# the MJCF importer
# ---------------------------------------------------------------------------

def _write_stl(path, tris: np.ndarray) -> None:
    """A binary STL of triangles (n, 3, 3)."""
    out = [b"\0" * 80, struct.pack("<I", len(tris))]
    for t in tris.astype(np.float32):
        out.append(np.zeros(3, np.float32).tobytes() + t.tobytes() + b"\0\0")
    path.write_bytes(b"".join(out))


MESH_SCENE = """
<mujoco>
  <asset><mesh name="link" file="link.stl" scale="1 2 1"/></asset>
  <worldbody>
    <body name="base" pos="0 0 0.5">
      <geom type="mesh" mesh="link" pos="0.1 0 0" euler="0 0 0.5"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.fixture()
def scenes(tmp_path):
    (tmp_path / "scene.xml").write_text(SYNTH)
    tris = np.random.default_rng(0).uniform(-0.05, 0.05, (12, 3, 3))
    _write_stl(tmp_path / "link.stl", tris)
    (tmp_path / "mesh.xml").write_text(MESH_SCENE)
    return tmp_path


def test_parse_matches_jax(scenes):
    got = mjcf.parse_mjcf(scenes / "scene.xml")
    want = jmjcf.parse_mjcf(scenes / "scene.xml")
    assert got.root_bodies == want.root_bodies
    assert list(got.bodies) == list(want.bodies)
    for name, b in want.bodies.items():
        g = got.bodies[name]
        assert g.parent == b.parent and g.children == b.children
        np.testing.assert_array_equal(g.pos, b.pos)
        np.testing.assert_array_equal(g.quat, b.quat)
        assert [(j.name, j.type) for j in g.joints] == \
            [(j.name, j.type) for j in b.joints]
        for jg, jb in zip(g.joints, b.joints):
            np.testing.assert_array_equal(jg.axis, jb.axis)
            np.testing.assert_array_equal(jg.range, jb.range)
        assert [(x.type, x.name) for x in g.geoms] == \
            [(x.type, x.name) for x in b.geoms]
        for xg, xb in zip(g.geoms, b.geoms):
            np.testing.assert_array_equal(xg.size, xb.size)
            np.testing.assert_array_equal(xg.rgba, xb.rgba)
    assert [(a.joint, a.kp) for a in got.actuators] == \
        [(a.joint, a.kp) for a in want.actuators]
    np.testing.assert_array_equal(got.keyframes[0], want.keyframes[0])


def test_chain_fk_limits_and_prims_match_jax(scenes):
    got_m = mjcf.parse_mjcf(scenes / "scene.xml")
    want_m = jmjcf.parse_mjcf(scenes / "scene.xml")
    chain = mjcf.chain_from_mjcf(got_m, "arm", tip_offset=[0.05, 0.0, 0.0])
    jchain = jmjcf.chain_from_mjcf(want_m, "arm", tip_offset=[0.05, 0.0, 0.0])
    assert chain.offsets.dtype == torch.float32
    for a, b in zip(chain, jchain):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    qs = np.random.default_rng(1).uniform(-1, 1, (5, 2)).astype(np.float32)
    pos, quat = K.fk(chain, torch.from_numpy(qs))
    for i, q in enumerate(qs):
        jpos, jquat = JK.fk(jchain, jnp.asarray(q))
        np.testing.assert_allclose(pos[i].numpy(), np.asarray(jpos), atol=1e-6)
        np.testing.assert_allclose(quat[i].numpy(), np.asarray(jquat),
                                   atol=1e-6)
    for a, b in zip(mjcf.chain_joint_limits(got_m, "arm"),
                    jmjcf.chain_joint_limits(want_m, "arm")):
        np.testing.assert_array_equal(a, b)
    got_p, want_p = (mjcf.static_scene_prims(got_m),
                     jmjcf.static_scene_prims(want_m))
    assert len(got_p) == len(want_p) == 1
    for k in ("pos", "half", "rgba"):
        np.testing.assert_array_equal(got_p[0][k], want_p[0][k])


def test_meshes_and_kdops_match_jax(scenes):
    stl = scenes / "link.stl"
    for a, b in zip(mjcf.stl_bbox(stl), jmjcf.stl_bbox(stl)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mjcf.stl_vertices(stl),
                                  jmjcf.stl_vertices(stl))
    for k in (6, 18, 26):
        np.testing.assert_array_equal(mjcf.kdop_directions(k),
                                      jmjcf.kdop_directions(k))
    verts = mjcf.stl_vertices(stl)
    np.testing.assert_array_equal(mjcf.fit_kdop(verts), jmjcf.fit_kdop(verts))
    got = mjcf.body_kdops(scenes / "mesh.xml", ["base"])
    want = jmjcf.body_kdops(scenes / "mesh.xml", ["base"])
    assert list(got) == list(want) == ["base"]
    np.testing.assert_array_equal(got["base"], want["base"])
    model = mjcf.parse_mjcf(scenes / "mesh.xml")
    jmodel = jmjcf.parse_mjcf(scenes / "mesh.xml")
    for a, b in zip(model.meshes["link"], jmodel.meshes["link"]):
        np.testing.assert_array_equal(a, b)
    got_p, want_p = (mjcf.static_scene_prims(model),
                     jmjcf.static_scene_prims(jmodel))
    np.testing.assert_array_equal(got_p[0]["half"], want_p[0]["half"])
    with pytest.raises(ValueError, match="6/18/26"):
        mjcf.kdop_directions(10)


# ---------------------------------------------------------------------------
# ALOHA-format HDF5
# ---------------------------------------------------------------------------

def _write_aloha(path, lengths, seed, latent_path=None):
    """``data/demo_i/{obs/<key>, action(s)}`` as ALOHA files hold them:
    the action key singular in some demos, ``num_samples`` on some only
    (shorter than the streams on one), and a latent companion with a
    frame more than the steps."""
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        lat = h5py.File(latent_path, "w") if latent_path else None
        for d, T in enumerate(lengths):
            g = f.create_group(f"data/demo_{d}")
            g.create_dataset("obs/qpos", data=rng.normal(size=(T + 2, 14))
                             .astype(np.float32))
            g.create_dataset("obs/wrist64_image", data=rng.integers(
                0, 256, (T + 2, 4, 4, 3), np.uint8))
            g.create_dataset("action" if d % 2 else "actions",
                             data=rng.uniform(-1, 1, (T + 2, 14))
                             .astype(np.float32))
            if d != 1:
                g.attrs["num_samples"] = T
            if lat is not None:
                lat.create_dataset(f"data/demo_{d}/latent/wrist64_image",
                                   data=rng.normal(size=(T + 3, 16))
                                   .astype(np.float32))
        if lat is not None:
            lat.close()


KEYS = ("qpos", "wrist64_image", "latent_wrist64_image", "optimal")


@pytest.fixture()
def aloha_files(tmp_path):
    files = {}
    for name, lengths, seed in (("a", (5, 7, 4), 0), ("b", (6, 3), 1),
                                ("e", (4, 5), 2)):
        files[name] = (str(tmp_path / f"{name}.hdf5"),
                       str(tmp_path / f"{name}_lat.hdf5"))
        _write_aloha(files[name][0], lengths, seed, files[name][1])
    return files


def test_load_aloha_matches_jax(aloha_files):
    path, lat = aloha_files["a"]
    got = ingest.load_aloha(path, KEYS, latent_path=lat, optimal=0.0)
    want = jingest.load_aloha(path, KEYS, latent_path=lat, optimal=0.0)
    _assert_welded_equal(got, want)
    # demo 1 has no num_samples: all of its actions (T + 2)
    assert got.demo_lengths.tolist() == [5, 9, 4]
    capped = ingest.load_aloha(path, ("qpos",), n_demos=2)
    _assert_welded_equal(capped, jingest.load_aloha(path, ("qpos",),
                                                    n_demos=2))
    with pytest.raises(ValueError, match="hdf5"):
        ingest.load_demos(path[:-4] + "npz", ("qpos",), format="aloha")


META = {"lowdim_obs": ["qpos"], "rgb_obs": ["latent_wrist64_image"],
        "shape_meta": {"ac_dim": 14, "all_shapes": {
            "qpos": [14], "latent_wrist64_image": [16]}}}


def test_facades_read_aloha_format(aloha_files):
    kw = dict(name="aloha", meta=META, format="aloha", batch_size=4,
              seq_length=3)
    (a, la), (b, lb), (e, le) = (aloha_files[k] for k in "abe")
    got = datasets.OfflineData(train_path=a, eval_path=e,
                               train_latent_path=la, eval_latent_path=le,
                               train_n_episode_overfit=2, device="cpu", **kw)
    want = jdatasets.OfflineData(train_path=a, eval_path=e,
                                 train_latent_path=la, eval_latent_path=le,
                                 train_n_episode_overfit=2, device_put=False,
                                 **kw)
    for split in ("train", "eval"):
        _assert_welded_equal(got.welded(split), want.welded(split))
    batch = next(got.train_dataloader())
    assert batch["actions"].shape == (4, 3, 14)
    # the mixed streams read the optimal flag: 1 on the expert sub, else 0
    kw["meta"] = {**META, "lowdim_obs": ["qpos", "optimal"]}
    mixed = datasets.MixedOfflineData(
        train_paths=[a, b], eval_paths=e, train_latent_paths=[la, lb],
        eval_latent_paths=le, train_split=[0.5, 0.5], device="cpu", **kw)
    jmixed = jdatasets.MixedOfflineData(
        train_paths=[a, b], eval_paths=e, train_latent_paths=[la, lb],
        eval_latent_paths=le, train_split=[0.5, 0.5], device_put=False, **kw)
    jmixed._train_mixed()
    jmixed._eval_dataset()
    _assert_welded_equal(mixed.welded("train"), jmixed._cat_welded)
    _assert_welded_equal(mixed.welded("eval"), jmixed._eval_welded)
    assert mixed.welded("train").arrays["optimal"][:, 0].tolist() == [1.0] * (
        mixed.sub_sizes[0]) + [0.0] * mixed.sub_sizes[1]
    with pytest.raises(ValueError, match="unknown dataset format"):
        datasets.OfflineData(train_path=a, eval_path=e, device="cpu",
                             **{**kw, "format": "lerobot"})
