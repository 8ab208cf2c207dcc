"""The port's host window prefetcher (``data/host_prefetch.py``, the JAX
package's C++ engine built from ``csrc/window_prefetch.cpp``) against the
JAX package's ``HostPrefetcher`` and the port's ``DeviceDataset.gather``:
the same seed samples the same indices and the same windows."""

import shutil

import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.data.host_prefetch import (
    HostPrefetcher as JaxHostPrefetcher)
from latent_diffusion_planning_tpu.data.ingest import (
    WeldedDemos as JaxWeldedDemos)
from latent_diffusion_planning_tpu_torch.data import host_prefetch
from latent_diffusion_planning_tpu_torch.data.host_prefetch import (
    HostPrefetcher)
from latent_diffusion_planning_tpu_torch.data.ingest import WeldedDemos
from latent_diffusion_planning_tpu_torch.data.windows import DeviceDataset
from latent_diffusion_planning_tpu_torch.ops.kernels import _build
from torch_thread import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

LENGTHS = (7, 5, 9)
OBS = ("robot0_eef_pos", "agentview_image")


def _arrays():
    rng = np.random.default_rng(0)
    total = sum(LENGTHS)
    return {
        "robot0_eef_pos": rng.normal(size=(total, 3)).astype(np.float32),
        "agentview_image": rng.integers(0, 255, (total, 8, 8, 3), np.uint8),
        "actions": rng.uniform(-1, 1, (total, 7)).astype(np.float32),
    }


def _extents():
    return np.cumsum([0] + list(LENGTHS[:-1])), np.asarray(LENGTHS)


def _welded(arrays=None):
    arrays = _arrays() if arrays is None else arrays
    starts, lengths = _extents()
    return WeldedDemos(
        arrays={k: torch.as_tensor(v) if not isinstance(v, np.memmap) else v
                for k, v in arrays.items()},
        demo_starts=torch.as_tensor(starts), demo_lengths=torch.as_tensor(
            lengths), obs_keys=OBS, dataset_keys=("actions",))


def _jax_welded():
    starts, lengths = _extents()
    return JaxWeldedDemos(arrays=_arrays(), demo_starts=starts,
                          demo_lengths=lengths, obs_keys=OBS,
                          dataset_keys=("actions",))


def test_same_indices_and_windows_as_jax_and_the_device_gather():
    fs, sl, B = 2, 4, 16
    kw = dict(frame_stack=fs, seq_length=sl, batch_size=B, n_slots=3,
              n_threads=1, seed=7)
    ref = JaxHostPrefetcher(_jax_welded(), **kw)
    pf = HostPrefetcher(_welded(), **kw, device="cpu")
    dd = DeviceDataset.from_welded(_welded(), fs, sl, "cpu")
    try:
        for _ in range(5):
            want, want_idx = ref.next_batch(return_indices=True)
            got, idx = pf.next_batch(return_indices=True)
            np.testing.assert_array_equal(idx.numpy(), want_idx)
            gathered = dd.gather(idx)
            for k in OBS:
                assert got["obs"][k].shape == (B, fs - 1 + sl) + (
                    want["obs"][k].shape[2:])
                np.testing.assert_array_equal(got["obs"][k].numpy(),
                                              want["obs"][k], err_msg=k)
                assert torch.equal(got["obs"][k], gathered["obs"][k]), k
            np.testing.assert_array_equal(got["actions"].numpy(),
                                          want["actions"])
            assert torch.equal(got["actions"], gathered["actions"])
    finally:
        ref.close()
        pf.close()


def test_threads_keep_the_gather_semantics():
    """Two workers fill the ring in either order; every batch still holds
    the windows of the indices it reports."""
    dd = DeviceDataset.from_welded(_welded(), 3, 2, "cpu")
    pf = HostPrefetcher(_welded(), 3, 2, 8, n_slots=4, n_threads=2, seed=1,
                        device="cpu")
    try:
        for _ in range(8):
            got, idx = pf.next_batch(return_indices=True)
            assert ((idx >= 0) & (idx < sum(LENGTHS))).all()
            ref = dd.gather(idx)
            for k in OBS:
                assert torch.equal(got["obs"][k], ref["obs"][k])
    finally:
        pf.close()


def test_deterministic_given_seed():
    def first_idx(seed):
        pf = HostPrefetcher(_welded(), frame_stack=1, seq_length=3,
                            batch_size=8, n_slots=1, n_threads=1, seed=seed,
                            device="cpu")
        try:
            return pf.next_batch(return_indices=True)[1]
        finally:
            pf.close()

    assert torch.equal(first_idx(3), first_idx(3))
    assert not torch.equal(first_idx(3), first_idx(4))


def test_memmapped_shards(tmp_path):
    mapped = {}
    for k, v in _arrays().items():
        np.save(tmp_path / f"{k}.npy", v)
        mapped[k] = np.load(tmp_path / f"{k}.npy", mmap_mode="r")
    pf = HostPrefetcher(_welded(mapped), frame_stack=1, seq_length=2,
                        batch_size=4, seed=0, device="cpu")
    try:
        batch = pf.next_batch()
        assert batch["obs"]["agentview_image"].shape == (4, 2, 8, 8, 3)
        assert batch["obs"]["agentview_image"].dtype == torch.uint8
        assert batch["actions"].dtype == torch.float32
    finally:
        pf.close()


def test_a_build_failure_raises_with_the_compiler_message(tmp_path,
                                                          monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / host_prefetch.SOURCE).write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed on window_prefetch.cpp"):
        HostPrefetcher(_welded(), 1, 2, 4, device="cpu")
    assert not host_prefetch.available()
    assert not list((tmp_path / "build").glob("*.so"))
