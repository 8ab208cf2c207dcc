"""Kernel B's fp32 instance, on the CPU: the plans that ``choose_tile`` and
``kernel_info`` give with ``dtype=float32`` at every default call and at
the bench planner (shared memory, samples a block, mode, grid, waves, the
bytes streamed to the SMs), the bf16 plans as they were, and the main
kernel's thread-private weight stream (``SliceTiles`` in
``csrc/unet1d.cuh``): which bytes each thread copies against the bytes its
GEMM reads, and its ring's order of copies, waits and reads.
"""

import pytest
import torch

from test_torch_ddpm import _meta_unet
from test_torch_fp32_kernel import DEFAULT_CALLS
from latent_diffusion_planning_tpu_torch.ops.kernels import (
    diffusion_unet1d as kunet)
from torch_thread import one_torch_thread  # noqa: F401

F32 = torch.float32
# the fp32 plan at the default LDP planner before this design (one sample a
# block, 256 blocks), 256 samples, DDPM-100: the bytes of weights its blocks
# streamed to the SMs
ONE_BLOCK_STREAM_BYTES = 6251198021632


def _call(name):
    D, Dc, dd, k, down, T, B = DEFAULT_CALLS[name]
    return _meta_unet(D, Dc, dd, k, down), T, B, (
        10 if name == "bench planner" else 100)


@pytest.mark.parametrize("call", sorted(DEFAULT_CALLS))
def test_fp32_plan_fits_a_block_in_one_wave(call):
    """At its batch every call's fp32 plan fits a block's shared memory
    (232,448 bytes) with a ring of 2-8 tiles, holds no more rows than its
    instance, and its blocks fit the H100's 132 SMs at once (one wave); the
    kernel's dims say whether the operand buffers sit in global memory."""
    net, T, B, S = _call(call)
    nb, prog = kunet.choose_tile(net, T, B, F32)
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT == 232448
    assert kunet.MIN_STAGES <= prog["stages"] <= kunet.MAX_STAGES
    assert nb * T <= (kunet.WIDE_MAX_ROWS if prog["wide"] else kunet.MAX_ROWS)
    assert kunet.prologue_smem_bytes(net, F32) <= kunet.SMEM_LIMIT
    info = kunet.kernel_info(net, B, T, S, dtype=F32)
    assert info["samples_per_block"] == nb and info["waves"] == 1
    assert info["grid"] <= kunet.H100_SMS
    dims = kunet._dims(net, B, T, S, nb, prog, F32)
    assert len(dims) == 34
    assert dims[30] == int(prog["wide"]) + int(prog["operands_global"])
    assert dims[33] == prog["skip32_total"] == 0


@pytest.mark.parametrize("B", [1, 255, 256, 257])
@pytest.mark.parametrize("call", ["ldp planner", "ldp_hier window",
                                  "ldp_hier chunk IDM", "bench planner"])
def test_fp32_grid_covers_ragged_batches(call, B):
    """A ragged batch runs in the fewest blocks that hold it (the last block
    holds what is left), the wide mode's scratch is sized to the grid, the
    waves are the grid over the SMs, and one sample takes one block."""
    net, T, _, S = _call(call)
    nb, prog = kunet.choose_tile(net, T, B, F32)
    info = kunet.kernel_info(net, B, T, S, dtype=F32)
    assert info["grid"] == -(-B // nb)
    assert info["waves"] == -(-info["grid"] // kunet.H100_SMS)
    assert info["scratch_bytes"] == info["grid"] * prog["scratch_bytes"]
    if B == 1:
        assert (nb, info["grid"]) == (1, 1)


def test_default_planner_takes_two_samples_a_block_in_one_wave():
    """At the default LDP planner (256 plans, DDPM-100) two samples share a
    block at T 16 in the wide mode, their operands in shared memory: 128
    blocks, one wave, half the one-sample plan's bytes (whose 256 blocks
    streamed 6.25 TB)."""
    net, T, B, S = _call("ldp planner")
    nb, prog = kunet.choose_tile(net, T, B, F32)
    assert nb == 2 and prog["wide"] and not prog["operands_global"]
    info = kunet.kernel_info(net, B, T, S, dtype=F32)
    one = kunet.kernel_info(net, B, T, S, nb=1, dtype=F32, wide=False)
    assert (info["grid"], one["grid"], one["waves"]) == (128, 256, 2)
    assert one["weight_bytes_streamed"] == ONE_BLOCK_STREAM_BYTES
    main = info["weight_bytes_per_step_and_block"] * S
    assert one["weight_bytes_streamed"] - info["weight_bytes_streamed"] == (
        128 * main)


def test_the_card_sm_count_sets_the_waves():
    """The plan counts waves on the card's SMs: on a card of 64 SMs the
    default planner's 128 blocks would take two waves, and the plan still
    fits and runs the same records."""
    net, T, B, S = _call("ldp planner")
    nb, prog = kunet.choose_tile(net, T, B, F32, sms=64)
    info = kunet.kernel_info(net, B, T, S, dtype=F32, sms=64)
    assert info["waves"] == -(-info["grid"] // 64) >= 2
    assert prog["smem_bytes"] <= kunet.SMEM_LIMIT
    assert prog["records"] == kunet.choose_tile(net, T, B, F32)[1]["records"]


# choose_tile / build_program / kernel_info for bf16 weights, as they were
# before the fp32 redesign: (nb, wide, ring stages, shared memory, scratch a
# block, max32, maxb, skip_total, grid, bytes streamed)
BF16_PLANS = {
    ("bench planner", 1): (8, False, 5, 217632, 0, 4608, 8448, 8576, 1,
                           111575040),
    ("bench planner", 256): (4, False, 7, 219424, 0, 2304, 4224, 4288, 64,
                             5299077120),
    ("bench planner", 257): (4, False, 7, 219424, 0, 2304, 4224, 4288, 65,
                             5381652480),
    ("bench planner", 1024): (8, False, 5, 217632, 0, 4608, 8448, 8576, 128,
                              10571120640),
    ("dp", 255): (2, False, 2, 216992, 0, 8448, 16512, 16576, 128,
                  1563562180608),
    ("dp obs_horizon 3", 256): (2, False, 2, 216992, 0, 8448, 16512, 16576,
                                128, 1563679653888),
    ("ldp planner", 1): (2, False, 2, 219296, 0, 8448, 16512, 16576, 1,
                         13048332288),
    ("ldp planner", 256): (2, False, 2, 219296, 0, 8448, 16512, 16576, 128,
                           1563327332352),
    ("ldp planner", 257): (2, False, 2, 219296, 0, 8448, 16512, 16576, 129,
                           1575535165440),
    ("ldp_hier chunk IDM", 1024): (4, False, 3, 223712, 0, 8320, 16512, 8320,
                                   256, 437059878912),
    ("ldp_hier planner", 256): (2, False, 3, 231360, 0, 8256, 16448, 12416,
                                128, 1504502218752),
    ("ldp_hier window", 1): (1, True, 4, 231584, 181760, 16512, 32896, 24832,
                             1, 12588761088),
    ("ldp_hier window", 257): (1, True, 4, 231584, 181760, 16512, 32896,
                               24832, 257, 3019908464640),
}


@pytest.mark.parametrize("call,B", sorted(BF16_PLANS))
def test_bf16_plans_are_unchanged(call, B):
    """The bf16 instances' plans are what they were: the same tile, mode,
    ring, shared memory, scratch, grid and stream at every default call."""
    net, T, _, S = _call(call)
    nb, prog = kunet.choose_tile(net, T, B)
    info = kunet.kernel_info(net, B, T, S)
    got = (nb, prog["wide"], prog["stages"], prog["smem_bytes"],
           prog["scratch_bytes"], prog["max32"], prog["maxb"],
           prog["skip_total"], info["grid"], info["weight_bytes_streamed"])
    assert got == BF16_PLANS[(call, B)]
    assert "operands_global" not in prog and "waves" not in info


WARPS, LANES, TILE_BYTES = 16, 32, 4 * kunet.TILE


def _copied(warp, lane, split_k):
    """SliceTiles' two 16-byte pieces of a tile for one thread (bytes)."""
    if split_k:
        off0 = 2 * (warp & 7) * 1024 + (warp >> 3) * 512 + lane * 16
        return {off0, off0 + 1024}
    off0 = warp * 1024 + lane * 16
    return {off0, off0 + 512}


def _read(warp, lane, split_k):
    """The 16-byte float4 reads of a tile in the fp32 GEMMs (bytes):
    ``gemm``'s ``tile + warp * 256 + lane * 4`` and 128 floats past it;
    ``gemm_ksplit``'s and ``gemm_ksplit_t``'s ``tile + kh * 128 + lane *
    4`` at 512 * cb and 256 floats past it."""
    if split_k:
        base = (warp >> 3) * 128 + lane * 4 + 512 * (warp & 7)
        return {4 * base, 4 * (base + 256)}
    base = warp * 256 + lane * 4
    return {4 * base, 4 * (base + 128)}


@pytest.mark.parametrize("split_k", [False, True])
def test_each_thread_copies_what_it_reads(split_k):
    """In both of the main kernel's GEMMs each thread reads exactly the two
    16-byte pieces of a tile it copied itself, and the 512 threads copy the
    16 KB tile exactly once between them: no thread reads another's copy,
    so the stream needs no barrier."""
    pieces = []
    for w in range(WARPS):
        for lane in range(LANES):
            assert _copied(w, lane, split_k) == _read(w, lane, split_k)
            pieces += sorted(_copied(w, lane, split_k))
    assert sorted(pieces) == list(range(0, TILE_BYTES, 16))


@pytest.mark.parametrize("stages,cycle,total",
                         [(2, 3, 7), (5, 14, 45), (8, 5, 40), (6, 6, 6)])
def test_slice_ring_reads_every_stage_from_its_copy(stages, cycle, total):
    """SliceTiles' order, as the kernel runs it for one thread: start()
    copies the first stages - 1 tiles; each tile() waits until at most
    stages - 2 of its copy groups are pending, copies the next tile into
    the slot it read last, and hands out the next slot. Each read finds its
    stage's copy complete and the stream's tile stage % cycle in the slot,
    and no copy lands in a slot whose tile is still to be read."""
    slot_tile = [None] * stages          # (stage, source tile) a slot holds
    left, src_stage, fill_slot, slot, n_groups = total, 0, 0, 0, 0
    read = set()

    def fill():
        nonlocal left, src_stage, fill_slot, n_groups
        if left > 0:
            held = slot_tile[fill_slot]
            assert held is None or held[0] in read, "overwrote an unread tile"
            slot_tile[fill_slot] = (total - left, src_stage)
            left -= 1
            src_stage = (src_stage + 1) % cycle
        fill_slot = (fill_slot + 1) % stages
        n_groups += 1                    # a commit, empty or not

    for _ in range(stages - 1):
        fill()
    for j in range(total):
        complete = n_groups - (stages - 2)   # groups done after the wait
        fill()
        assert slot_tile[slot] == (j, j % cycle) and j < complete
        read.add(j)
        slot = (slot + 1) % stages
    assert len(read) == total
