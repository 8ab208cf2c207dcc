"""Fused U-Net sampler for ConditionalUnet1D: CUDA kernel + plain twin.

Replaces the TPU kernel ``latent_diffusion_planning_tpu/ops/pallas/
diffusion_unet1d.py`` (``fused_unet1d_ddim_sample`` → ``_kernel``, both its
VMEM-resident and its streamed-weights mode). The kernel
(``csrc/diffusion_unet1d.cu``) runs every step of the planner U-Net's
reverse process for a tile of samples in one launch: η=0 DDIM as the JAX
kernel does, or ancestral DDPM with per-step noise handed in (the JAX
package samples its default configurations, DDPM-100, with its XLA scan).
Every conv is an implicit GEMM on the tensor cores (bf16 × bf16
``mma.sync``, fp32 accumulators); GroupNorm, Mish, FiLM and the step update
are fp32. On the card it is bound by the weight stream: every block reads
every conv weight once per step from L2 (or HBM, when the net is larger than
L2). The design is built around that stream — weights are packed once, in
exactly the order and fragment layout the kernel consumes them, and flow
through a shared-memory ring of asynchronous copies that runs ahead across
op and step boundaries — and it shrinks the stream: the time MLP and the
FiLM projections, which do not depend on the sample or do not depend on the
step, are computed once by a small prologue kernel of the same launch (see
the source's note).

Packed layout (``pack_params``), one bf16 buffer:

    [ main stream | time stream | cond stream | vectors ]

A stream is a sequence of 8 KB *tiles*; a tile is 32 rows of K × 128 columns
of N of one GEMM's (K, N) weight matrix, stored in ``mma`` B-fragment order
(``tile_matrix``). A GEMM's tiles run N-group major, then along K; K is
``taps × pad32(Cin)`` (zero rows in the padding), N is padded to 128. The main
stream holds the convs in the order the program runs them, padded with zero
tiles to a whole number of ring stages; the time stream holds the time MLP
and the time half of every FiLM projection; the cond stream the
global-condition half. ``vectors`` holds biases and GroupNorm scales.

The net reaches the kernel as that buffer plus a small program of 12-int
records (``build_program``), so any ``down_dims``, ``n_groups`` and embedding
width runs through the same kernel, and so does a net that does not
downsample (``downsample=False``, LDP-hier's planner and chunk IDM): its
program has no DOWN or UP record, and every level runs at the full length.
Where no tile of such a net fits the shared memory whole (LDP-hier's
default planner [256,512,1024] at 16 rows), the program runs in *wide*
mode: the fp32 activation buffers and the skips move to a per-block slice
of a global scratch, the same records, the same weight stream; where even
the operand buffers do not fit beside the ring (``operands_global``: a
[1024,2048,4096] planner), they move to the scratch too, and the bf16 GEMM
reads its input through a window of channels staged in shared memory for
``ldmatrix`` (``stage_elems``: the whole input where it fits). A tile of
several samples holds up to ``MAX_ROWS`` GEMM rows (samples × time steps;
``WIDE_MAX_ROWS`` in the wide mode), and one sample any number: a GEMM of
more rows than its instance holds (16 row tiles in bf16 and fp16, 8 in
fp32, 2 in the fp32 wide mode) walks them in groups, each group a pass
over the GEMM's weight tiles, the ones before the last read from global
memory (the stream has brought them into L2). An up block whose
concatenated input is as wide as its output has no projection, so its
residual is that input in fp32: the program then keeps an fp32 copy of the
skip beside the bf16 one (``skip32``) and concatenates both halves in fp32.

Three weight types, one template each (``csrc/unet1d.cuh``): bf16 (the
default, ``diffusion_unet1d.cu``), fp16 (``dtype=torch.float16``, the JAX
kernel's ``dtype=float16``; ``diffusion_unet1d_f16.cu``: bf16's tiles and
program with fp16 operands, rounding where the JAX kernel rounds, see
``rounding_twin``) and fp32 (``dtype=torch.float32``, the JAX
kernel's ``dtype=float32`` that ``fused_dtype: float32`` selects;
``diffusion_unet1d_f32.cu``): fp32 tiles of 16 KB, one a ring stage, fp32
operand buffers, products as 3×TF32 on the tensor cores. The layout, the
program and the tile choice take the dtype; the records are the same. The
fp32 main kernel streams each thread's own bytes of every tile (no barrier
a stage), and its plan (``choose_tile``) picks samples a block and mode by
waves of blocks on the card times a block's work, then by the bytes it
streams: two samples a block at the default widths, in the wide mode.

The condition half of FiLM's projection is streamed in chunks of
``COND_CHUNK`` condition channels (GEMMs ``film_g.0``, ``film_g.1``, …), so
the prologue holds one chunk's operands at a time and takes a condition of
any width at 64 samples a block.

The twin computes the same update with the module's own weights in fp32; to
hold the bf16 kernel against it on the card, give the twin
``rounding_twin(net)``: bf16-rounded weights and every conv and dense input
rounded through bf16, which is where the kernel rounds; the fp16 kernel's
is ``rounding_twin(net, torch.float16)``. The fp32 kernel's twin is the net
itself (under ``fp32_math``).
"""

from __future__ import annotations

import copy
import functools

import torch

from ...models.nets.unet1d import (ConditionalUnet1D, ConvBlock1D,
                                   FiLMResBlock1D)
from .. import diffusion as dlib
from . import _build

SMEM_LIMIT = 232448     # bytes of shared memory one block may use on H100
NB_CHOICES = (16, 8, 4, 2, 1)   # samples per block
MIN_BLOCKS = 64         # prefer a tile that leaves at least this many blocks
MAX_ROWS = 128          # GEMM rows (samples × time steps) of a tile of
WIDE_MAX_ROWS = 32      # several samples (in the wide mode); one sample any
WEIGHT_DTYPE = torch.bfloat16   # the default weight type
WEIGHT_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
ENTRIES = {torch.bfloat16: "ldp_unet1d_sampler",
           torch.float16: "ldp_unet1d_sampler_f16",
           torch.float32: "ldp_unet1d_sampler_f32"}

WARPS = 16                      # warps of a block; each owns 8 columns
TILE_K, TILE_N = 32, 8 * WARPS
TILE = TILE_K * TILE_N          # bf16 elements in a tile (8 KB)
STAGE_TILES = 3                 # bf16 tiles per ring stage (24 KB)
STAGE_BYTES = STAGE_TILES * TILE * 2
MIN_STAGES, MAX_STAGES = 2, 8   # ring depth: as deep as shared memory allows
PROLOGUE_STAGES = 3
COND_ROWS = 64                  # samples per prologue block (cond half)
COND_CHUNK = 256                # condition channels it holds at a time
REC = 12                        # ints per program record
# bf16 operands in global memory: a GEMM stages a window of its input rows'
# channels in shared memory, at least three 32-channel tiles of every row at
# this row stride (elements), and as much of a row as fits beside a ring of
# STAGED_RING stages
STAGED_LD = 3 * TILE_K + 8
STAGED_RING = 4
# the fp32 wide GEMM's partial sums (two buffers of 16 warps x 32 lanes x
# 2 row tiles x 4), at the end of a block's slice of the scratch
F32_RED_BYTES = 4 * 2 * 16 * 32 * 2 * 4
H100_SMS = 132                  # one block an SM: the blocks of a wave

FILM, SAVE, CONCAT, DOWN, UP, FINAL_BLOCK, FINAL_CONV = range(7)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in WEIGHT_DTYPES:
        raise ValueError(f"kernel B takes bfloat16, float16 or float32 "
                         f"weights, not {dtype}")
    return dtype


def esize(dtype: torch.dtype = WEIGHT_DTYPE) -> int:
    """Bytes of a weight and of an operand element."""
    return _check_dtype(dtype).itemsize


def stage_tiles(dtype: torch.dtype = WEIGHT_DTYPE) -> int:
    """Tiles per ring stage: 3 of 8 KB in bf16 and fp16, 1 of 16 KB in
    fp32."""
    return STAGE_TILES if esize(dtype) == 2 else 1


def stage_bytes(dtype: torch.dtype = WEIGHT_DTYPE) -> int:
    return stage_tiles(dtype) * TILE * esize(dtype)


def ldb(C: int, dtype: torch.dtype = WEIGHT_DTYPE) -> int:
    """Row stride (elements) of a C-channel operand buffer: channels padded
    to the tile depth, plus 8 bf16 so ``ldmatrix`` rows miss each other's
    banks, or plus 16 floats so the fp32 GEMM's 16-byte loads of two rows
    (a quarter warp's) do."""
    return _up(C, TILE_K) + (8 if esize(dtype) == 2 else 16)


def ld32(C: int) -> int:
    """Row stride (floats) of a C-channel fp32 buffer."""
    return C + 8


def row_group(wide: bool, dtype: torch.dtype = WEIGHT_DTYPE) -> int:
    """The rows an instance holds at once (16 row tiles in bf16 and fp16, 8
    in fp32, 2 in the fp32 wide mode); a GEMM of more walks them in groups
    of this many, one pass over its weight tiles each."""
    return 16 * (16 if esize(dtype) == 2 else 2 if wide else 8)


def rows_fit(nb: int, T: int, wide: bool,
             dtype: torch.dtype = WEIGHT_DTYPE) -> bool:
    """Whether a tile of ``nb`` samples of length ``T`` has rows the kernel
    takes: ``MAX_ROWS`` (``WIDE_MAX_ROWS`` in the wide mode), or one sample
    of any length (past ``row_group`` its GEMMs walk their rows in
    groups)."""
    return nb * T <= (WIDE_MAX_ROWS if wide else MAX_ROWS) or nb == 1


def check_supported(net: ConditionalUnet1D, T: int,
                    dtype: torch.dtype = WEIGHT_DTYPE) -> None:
    """Raise ValueError, with the reason, for a call the kernel cannot run:
    a plan length the U-Net's stride does not divide (the JAX agent samples
    it with its scan), an even kernel_size (the JAX net does not build), or
    widths GroupNorm cannot split. (A net too wide for a block's shared
    memory at this length is refused by ``choose_tile``.)"""
    _check_dtype(dtype)
    dd = net.down_dims
    stride = 2 ** (len(dd) - 1) if net.downsample else 1
    if T % stride:
        raise ValueError(f"plan length {T} not divisible by the U-Net stride "
                         f"{stride}")
    if any(ch % net.n_groups for ch in dd):
        raise ValueError("every down_dims entry must divide into n_groups")
    if net.kernel_size % 2 == 0:
        raise ValueError("kernel needs an odd kernel_size")


def _skip32_levels(dd, downsample: bool) -> set:
    """Levels whose skip an up block without a projection reads back: the
    block's input, [h | skip], as wide as its output, is its residual."""
    out, cin = set(), dd[-1]
    for lvl in range(len(dd) - 1, 0, -1):
        if cin + dd[lvl] == dd[lvl - 1]:
            out.add(lvl)
        cin = dd[lvl - 1]
    return out


# ---------------------------------------------------------------------------
# the net as GEMMs, in the order the kernel runs them
# ---------------------------------------------------------------------------

def _conv_kio(conv: torch.nn.Conv1d) -> torch.Tensor:
    """torch (Cout, Cin, k) → the kernel's (k, Cin, Cout)."""
    return conv.weight.permute(2, 1, 0)


def _walk(L: int, downsample: bool):
    """The ops of a U-Net of L levels in execution order: ("film", block
    index, level), ("save", level), ("down", i), ("concat", level),
    ("up", j), ("final_block",), ("final_conv",); no "down" or "up" when
    the net does not downsample."""
    n = 0
    for i in range(L):
        yield ("film", n, i)
        yield ("film", n + 1, i)
        n += 2
        if i:
            yield ("save", i)
        if downsample and i < L - 1:
            yield ("down", i)
    yield ("film", n, L - 1)
    yield ("film", n + 1, L - 1)
    n += 2
    for j, lvl in enumerate(range(L - 1, 0, -1)):
        yield ("concat", lvl)
        yield ("film", n, lvl)
        yield ("film", n + 1, lvl)
        n += 2
        if downsample:
            yield ("up", j)
    yield ("final_block",)
    yield ("final_conv",)


def _gemms(net: ConditionalUnet1D) -> dict:
    """The net's weight matrices by stream: name → ((taps, Cin, Cout)
    weight, vectors), where vectors are [bias, GroupNorm scale, GroupNorm
    bias] as far as the GEMM has them."""
    conv = lambda c: (_conv_kio(c), [c.bias])
    block = lambda b: (_conv_kio(b.conv), [b.conv.bias, b.norm.weight,
                                           b.norm.bias])
    main = []
    for op in _walk(len(net.down_dims), net.downsample):
        if op[0] == "film":
            i, blk = op[1], net.blocks[op[1]]
            main += [(f"conv1.{i}", *block(blk.block0)),
                     (f"conv2.{i}", *block(blk.block1))]
            if blk.proj is not None:
                main.append((f"proj.{i}", *conv(blk.proj)))
        elif op[0] == "down":
            main.append((f"down.{op[1]}", *conv(net.downs[op[1]])))
        elif op[0] == "up":
            up = net.ups[op[1]]
            # stored flipped for torch's conv_transpose1d; the kernel takes
            # the Flax taps, x[t] w[j] -> y[2t+2-j]
            main.append((f"up.{op[1]}", up.weight.flip(-1).permute(2, 0, 1),
                         [up.bias]))
        elif op[0] == "final_block":
            main.append(("final_block", *block(net.final_block)))
        elif op[0] == "final_conv":
            main.append(("final_conv", *conv(net.final_conv)))
    d = net.dsed
    film_w = torch.cat([b.film.weight for b in net.blocks], 0)   # (FT, cond)
    film_b = torch.cat([b.film.bias for b in net.blocks], 0)
    dense = lambda lin: (lin.weight.t()[None], [lin.bias])
    time = [("time0", *dense(net.time_dense0)),
            ("time1", *dense(net.time_dense1)),
            ("film_t", film_w[:, :d].t()[None], [film_b])]
    gw = film_w[:, d:].t()                                        # (cond, FT)
    cond = [(f"film_g.{i}", gw[c0:c0 + COND_CHUNK][None], [])
            for i, c0 in enumerate(range(0, gw.shape[0], COND_CHUNK))]
    return {"main": main, "time": time, "cond": cond}


def tile_matrix(w: torch.Tensor) -> torch.Tensor:
    """(K, N) → flat tiles, K padded to 32 and N to 128 with zeros. Tiles
    run N-group major, then along K. Inside a tile, element (k, n) sits at
    ``[n // 8][(n % 8) * 4 + (k % 8) // 2][(k // 16) * 4 + (k % 16 // 8) * 2
    + k % 2]`` of a (16 warps, 32 lanes, 8 values) block: lane ``l`` of warp
    ``w`` reads its two ``m16n8k16`` B fragments as one 16-byte word."""
    K, N = w.shape
    Kp, Np = _up(K, TILE_K), _up(N, TILE_N)
    full = w.new_zeros((Kp, Np))
    full[:K, :N] = w
    # k = kt*32 + kc*16 + half*8 + tq*2 + lo ; n = ng*128 + warp*8 + g
    v = full.reshape(Kp // 32, 2, 2, 4, 2, Np // TILE_N, WARPS, 8)
    #      dims:     kt     kc half tq lo  ng      warp g
    return v.permute(5, 0, 6, 7, 3, 1, 2, 4).reshape(-1)


def untile_matrix(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of ``tile_matrix``: the padded (pad32(K), pad128(N)) matrix."""
    Kp, Np = _up(K, TILE_K), _up(N, TILE_N)
    v = flat.reshape(Np // TILE_N, Kp // 32, WARPS, 8, 4, 2, 2, 2)
    return v.permute(1, 5, 6, 4, 7, 0, 2, 3).reshape(Kp, Np)


def tile_matrix_f32(w: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel's tiles of a (K, N) matrix: the same tiles (32 K-rows
    × 128 columns, N-group major, then along K), each in the fp32 GEMM's
    ``m16n8k8`` TF32 fragment order: element (k, n) sits at ``[n // 8][k //
    16][(n % 8) * 4 + k % 16 // 4][k % 4]`` of a (16 warps, 2, 32 lanes, 4)
    block. Lane ``l = 4 g + tq`` of warp ``w`` reads rows ``16 h + 4 tq``
    to ``+ 3`` of column ``8 w + g`` as one 16-byte word a K-half ``h``,
    each read of the warp 512 contiguous bytes: the B fragments of two
    8-row steps whose K slots ``tq`` and ``tq + 4`` are rows ``4 tq + 2 s``
    and ``+ 1`` (the mma sums over slots, so any assignment that A shares
    is the product), which lets the activations' slots, the same four
    consecutive channels, load as one 16-byte word too."""
    K, N = w.shape
    Kp, Np = _up(K, TILE_K), _up(N, TILE_N)
    full = w.new_zeros((Kp, Np))
    full[:K, :N] = w
    # k = kt*32 + kh*16 + tq*4 + e ; n = ng*128 + warp*8 + g
    v = full.reshape(Kp // 32, 2, 4, 4, Np // TILE_N, WARPS, 8)
    #      dims:     kt     kh tq e  ng            warp  g
    return v.permute(4, 0, 5, 1, 6, 2, 3).reshape(-1)


def untile_matrix_f32(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of ``tile_matrix_f32``."""
    Kp, Np = _up(K, TILE_K), _up(N, TILE_N)
    v = flat.reshape(Np // TILE_N, Kp // 32, WARPS, 2, 8, 4, 4)
    return v.permute(1, 3, 5, 6, 0, 2, 4).reshape(Kp, Np)


def _pad_taps(w: torch.Tensor) -> torch.Tensor:
    """(taps, Cin, Cout) → (taps × pad32(Cin), Cout), zero rows in the pad."""
    taps, cin, cout = w.shape
    full = w.new_zeros((taps, _up(cin, TILE_K), cout))
    full[:, :cin] = w
    return full.reshape(-1, cout)


def _signature(net: ConditionalUnet1D) -> tuple:
    """What the net's structure follows from (its constructor arguments)."""
    return (net.input_dim, net.global_cond_dim, net.dsed, net.down_dims,
            net.kernel_size, net.n_groups, net.downsample)


def layout(net: ConditionalUnet1D,
           dtype: torch.dtype = WEIGHT_DTYPE) -> dict:
    """Where everything sits in the packed buffer. Offsets of tiles are in
    tiles from the start of their stream; offsets of vectors in elements from
    the start of the vector region. Depends on the net's shapes and the
    weight type (streams are padded to whole ring stages) only."""
    return _layout(_signature(net), _check_dtype(dtype))


@functools.lru_cache(maxsize=16)
def _layout(signature: tuple, dtype: torch.dtype = WEIGHT_DTYPE) -> dict:
    per_stage = stage_tiles(dtype)
    with torch.device("meta"):
        gemms = _gemms(ConditionalUnet1D(*signature))
    out = {"gemm": {}, "stream": {}}
    base = 0            # tiles from the start of the buffer
    voff = 0
    for stream in ("main", "time", "cond"):
        t = 0
        for name, w, vecs in gemms[stream]:
            taps, cin, cout = w.shape
            n_tiles = (taps * _up(cin, TILE_K) // TILE_K) * (_up(cout, TILE_N)
                                                              // TILE_N)
            out["gemm"][name] = dict(stream=stream, tile_off=t,
                                     n_tiles=n_tiles, vec_off=voff,
                                     taps=taps, cin=cin, cout=cout)
            if vecs:
                voff += _up(cout, TILE_N) + sum(v.numel() for v in vecs[1:])
            t += n_tiles
        stages = -(-t // per_stage)
        out["stream"][stream] = dict(tile_base=base, n_tiles=t, stages=stages)
        base += stages * per_stage
    out["vec_base"] = base * TILE
    out["n_vec"] = voff
    out["numel"] = base * TILE + voff
    foff, o = [], 0
    for name, g in out["gemm"].items():
        if name.startswith("conv1."):
            foff.append(o)
            o += 2 * g["cout"]
    out["film_off"] = foff
    out["film_total"] = o
    out["film_ld"] = _up(o, TILE_N)
    return out


def pack_params(net: ConditionalUnet1D,
                dtype: torch.dtype = WEIGHT_DTYPE) -> torch.Tensor:
    """Every weight of the net in ``dtype`` (bf16 or fp32), tiled and
    ordered as that kernel consumes it (see the module docstring)."""
    gemms = _gemms(net)
    lay = layout(net, dtype)
    tile = tile_matrix if esize(dtype) == 2 else tile_matrix_f32
    tiles, vecs_out = [], []
    with torch.no_grad():
        for stream in ("main", "time", "cond"):
            n = 0
            for name, w, vecs in gemms[stream]:
                t = tile(_pad_taps(w.detach().float()))
                tiles.append(t)
                n += t.numel() // TILE
                if vecs:
                    bias = torch.zeros(_up(w.shape[2], TILE_N))
                    bias[:w.shape[2]] = vecs[0].detach().float().cpu()
                    vecs_out += [bias] + [v.detach().float().cpu()
                                          for v in vecs[1:]]
            pad = lay["stream"][stream]["stages"] * stage_tiles(dtype) - n
            tiles.append(torch.zeros(pad * TILE))
        flat = torch.cat([t.cpu() for t in tiles] + vecs_out)
    assert flat.numel() == lay["numel"]
    return flat.to(dtype)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def build_program(net: ConditionalUnet1D, T: int, nb: int,
                  wide: bool = False,
                  dtype: torch.dtype = WEIGHT_DTYPE) -> dict:
    """The kernel's program for this net, a tile of ``nb`` samples and plan
    length ``T``, in wide mode or not, for weights of ``dtype`` (cached by
    the net's shapes; do not edit what it returns)."""
    return _build_program(_signature(net), T, nb, wide, _check_dtype(dtype))


@functools.lru_cache(maxsize=64)
def _build_program(signature: tuple, T: int, nb: int,
                   wide: bool = False,
                   dtype: torch.dtype = WEIGHT_DTYPE) -> dict:
    """The kernel's op records and its memory layout for a tile of ``nb``
    samples of length ``T``: in shared memory the weight ring, the fp32
    buffers X32/Y32, the current sample, the GroupNorm statistics, the
    operand buffers Xb/Yb (of the weight type) and the skips; in wide mode
    X32, Y32 and the skips in ``scratch_bytes`` of global memory a block
    instead, and with fp32 weights Xb and Yb too where they do not fit
    shared memory beside the ring (``operands_global``). The records do not
    depend on the mode; their skip offsets (in operand elements) on the
    dtype.

    Records (12 ints, unused fields 0):
      FILM         cin ch Tl tile(conv1) tile(conv2) film_off tile(proj)|-1
                   vec(conv1) vec(conv2) vec(proj)
      SAVE         skip_off C Tl has32 skip32_off
      CONCAT       skip_off C_h C_skip Tl has32 skip32_off
      DOWN / UP    ch Tl_in tile vec
      FINAL_BLOCK  cin ch Tl tile vec
      FINAL_CONV   cin D Tl tile vec
    Tile offsets are in tiles from the start of the main stream; the kernel
    consumes the stream in order and never seeks, so they must be contiguous
    in program order (the tests check that).
    """
    lay = _layout(signature, dtype)
    gm = lay["gemm"]
    D, _, _, dd, _, n_groups, downsample = signature
    dd = list(dd)
    ldb_ = functools.partial(ldb, dtype=dtype)
    recs = []
    max32 = T * ld32(D)          # floats per sample, fp32 buffers
    maxb = T * ldb_(D)           # elements per sample, operand buffers

    def rec(*v):
        recs.append(list(v) + [0] * (REC - len(v)))

    # one bf16 skip slot per level >= 1 (the level-0 skip is never read
    # back), and an fp32 one (floats) where an up block without a
    # projection adds the skip to its residual
    slot, skip_total = {}, 0
    slot32, skip32_total = {}, 0
    need32 = _skip32_levels(dd, downsample)
    for i in range(1, len(dd)):
        tl = T >> i if downsample else T
        slot[i] = skip_total
        skip_total += nb * tl * ldb_(dd[i])
        if i in need32:
            slot32[i] = skip32_total
            skip32_total += nb * tl * ld32(dd[i])

    Tl, cin = T, D
    for op in _walk(len(dd), downsample):
        kind = op[0]
        if kind == "film":
            i = op[1]
            ch = gm[f"conv1.{i}"]["cout"]
            proj = gm.get(f"proj.{i}")
            rec(FILM, cin, ch, Tl, gm[f"conv1.{i}"]["tile_off"],
                gm[f"conv2.{i}"]["tile_off"], lay["film_off"][i],
                proj["tile_off"] if proj else -1, gm[f"conv1.{i}"]["vec_off"],
                gm[f"conv2.{i}"]["vec_off"], proj["vec_off"] if proj else 0)
            max32 = max(max32, Tl * ld32(ch))
            maxb = max(maxb, Tl * ldb_(cin), Tl * ldb_(ch))
            cin = ch
        elif kind == "save":
            lvl = op[1]
            rec(SAVE, slot[lvl], cin, Tl,
                *((1, slot32[lvl]) if lvl in slot32 else ()))
        elif kind == "concat":
            lvl = op[1]
            rec(CONCAT, slot[lvl], cin, dd[lvl], Tl,
                *((1, slot32[lvl]) if lvl in slot32 else ()))
            cin += dd[lvl]
            maxb = max(maxb, Tl * ldb_(cin))
            if lvl in slot32:
                max32 = max(max32, Tl * ld32(cin))
        elif kind in ("down", "up"):
            g = gm[f"{kind}.{op[1]}"]
            rec(DOWN if kind == "down" else UP, cin, Tl, g["tile_off"],
                g["vec_off"])
            Tl = Tl // 2 if kind == "down" else Tl * 2
            max32 = max(max32, Tl * ld32(cin))
            maxb = max(maxb, Tl * ldb_(cin))
        elif kind == "final_block":
            g = gm["final_block"]
            rec(FINAL_BLOCK, cin, dd[0], Tl, g["tile_off"], g["vec_off"])
        else:
            g = gm["final_conv"]
            rec(FINAL_CONV, dd[0], D, Tl, g["tile_off"], g["vec_off"])

    small = nb * T * D + 2 * nb * n_groups     # the sample, the statistics
    es = esize(dtype)
    # X32 and Y32 (nb samples each); fp32 rounds them to whole 16 bytes, so
    # operand buffers placed after them take 16-byte loads
    m32 = nb * max32 if es == 2 and not wide else _up(nb * max32, 4)
    sb = stage_bytes(dtype)
    s32 = 4 * skip32_total      # bytes of the fp32 skips, after the bf16 ones
    red = F32_RED_BYTES if es == 4 else 0
    operands_global, window = False, 0
    if wide:
        # the operand buffers in shared memory where they fit beside a ring
        # of MIN_STAGES, else in the scratch too: plain loads in fp32, and
        # in bf16 staged through a window in shared memory
        floats, elems = _up(small, 4), 2 * nb * maxb + 16
        scratch = _up(4 * 2 * m32 + es * skip_total + s32 + red, 256)
        if 4 * floats + es * elems + MIN_STAGES * sb > SMEM_LIMIT:
            operands_global = True
            if es == 2:
                # the staging window: the widest operand buffer where it
                # fits beside a ring of STAGED_RING, else what room is left
                room = (SMEM_LIMIT - STAGED_RING * sb - 4 * floats) // 2 - 16
                window = max(nb * T * STAGED_LD, min(nb * maxb, room) & ~7)
            elems = 16 + window
            scratch = _up(4 * 2 * m32 + es * (2 * nb * maxb + skip_total)
                          + s32 + red, 256)
    else:
        floats = _up(2 * m32 + small, 4)
        elems = 2 * nb * maxb + skip_total + s32 // es + 16
        scratch = 0
    rest = 4 * floats + es * elems
    stages = min(MAX_STAGES, max(MIN_STAGES, (SMEM_LIMIT - rest) // sb))
    out = dict(records=recs, max32=m32, maxb=nb * maxb,
               skip_total=skip_total, skip32_total=skip32_total,
               stages=stages, smem_bytes=stages * sb + rest, wide=wide,
               scratch_bytes=scratch, dtype=dtype)
    if es == 4 or operands_global:
        out["operands_global"] = operands_global
    if window:
        out["stage_elems"] = window
    return out


def prologue_smem_bytes(net: ConditionalUnet1D,
                        dtype: torch.dtype = WEIGHT_DTYPE) -> int:
    """Shared memory of the prologue kernel: the ring, two operand buffers
    wide enough for the time MLP's hidden layer or ``COND_ROWS`` samples of
    one ``COND_CHUNK``-channel chunk of the condition (so at any condition
    width), and a zero row."""
    elems = max(16 * ldb(4 * net.dsed, dtype),
                COND_ROWS * ldb(COND_CHUNK, dtype))
    return (PROLOGUE_STAGES * stage_bytes(dtype)
            + esize(dtype) * (2 * elems + 16))


def _fits(net: ConditionalUnet1D, T: int, dtype: torch.dtype,
          every_mode: bool) -> list:
    """(nb, program) of every tile that fits a block, most samples first:
    the ordinary mode, then (where none fits, or ``every_mode``) the wide;
    bf16 takes the wide mode with its operands in global memory only where
    no tile fits otherwise."""
    fits = []
    # (wide, operands in global memory): None lets the program choose
    modes = (((False, False), (True, False), (True, True))
             if esize(dtype) == 2 else ((False, None), (True, None)))
    for wide, global_ops in modes:
        if fits and not every_mode:
            break
        for nb in NB_CHOICES:
            if not rows_fit(nb, T, wide, dtype):
                continue
            prog = build_program(net, T, nb, wide, dtype)
            if (global_ops is not None
                    and prog.get("operands_global", False) != global_ops):
                continue
            if prog["smem_bytes"] <= SMEM_LIMIT:
                fits.append((nb, prog))
    if not fits:
        raise ValueError("net too wide for the kernel's shared memory at "
                         f"length {T}, even with its buffers, skips and "
                         f"operands in global memory")
    return fits


@functools.lru_cache(maxsize=64)
def _stream_rows(signature: tuple, T: int) -> tuple:
    """(tiles, output length) of every GEMM of the main stream, in order."""
    gm = _layout(signature, torch.float32)["gemm"]
    out, Tl = [], T
    for op in _walk(len(signature[3]), signature[6]):
        if op[0] == "film":
            names = [f"conv1.{op[1]}", f"conv2.{op[1]}", f"proj.{op[1]}"]
        elif op[0] in ("down", "up"):
            Tl = Tl // 2 if op[0] == "down" else 2 * Tl
            names = [f"{op[0]}.{op[1]}"]
        elif op[0] in ("final_block", "final_conv"):
            names = [op[0]]
        else:
            names = []
        out += [(gm[n]["n_tiles"], Tl) for n in names if n in gm]
    return tuple(out)


TILE_FIXED = 0.4    # a tile's own work (wait, B split) in row tiles' work


def block_cost(net: ConditionalUnet1D, T: int, nb: int,
               wide: bool = False) -> float:
    """The fp32 main kernel's work a block and step, in units of one m16
    row tile's work on one weight tile: every tile of the stream costs
    ``TILE_FIXED`` plus the row tiles its GEMM has at ``nb`` samples (the
    deep levels' rows are few, so a second sample there is nearly free);
    the wide instance runs a GEMM of at most 8 rows transposed, on half a
    row tile's products."""
    def row_tiles(rows):
        return 0.5 if wide and rows <= 8 else -(-rows // 16)
    return sum(n * (TILE_FIXED + row_tiles(nb * tl))
               for n, tl in _stream_rows(_signature(net), T))


def choose_tile(net: ConditionalUnet1D, T: int, B: int | None = None,
                dtype: torch.dtype = WEIGHT_DTYPE,
                sms: int = H100_SMS) -> tuple[int, dict]:
    """Samples per block and the program for them.

    bf16: the most that fit the shared memory and the GEMM's row limit, but
    no more than leaves ``MIN_BLOCKS`` blocks for a batch of ``B`` (the
    weight stream a block reads is the same whatever it holds, so larger
    tiles divide the L2 traffic; too few blocks leave the card empty). Wide
    mode only where no tile fits whole, so a net that fits keeps its tiles.

    fp32: every tile in both modes is a candidate (the wide mode keeps the
    fp32 buffers and skips in global memory, so it holds more samples). For
    a batch of ``B`` the tile and mode that take the least work: waves of
    blocks on ``sms`` SMs (one block an SM) times a block's work
    (``block_cost``); then the fewest blocks (bytes streamed), the fewest
    padding samples, the ordinary mode. Without ``B``: the largest tile,
    the ordinary mode where one fits."""
    f32 = esize(dtype) == 4
    fits = _fits(net, T, dtype, every_mode=f32 and B is not None)
    if B is None:
        return fits[0]
    if not f32:
        return next(f for f in fits if -(-B // f[0]) >= min(MIN_BLOCKS, B))

    def key(fit):
        nb, prog = fit
        blocks = -(-B // nb)
        return (-(-blocks // sms) * block_cost(net, T, nb, prog["wide"]),
                blocks, blocks * nb - B, prog["wide"])
    return min(fits, key=key)


# ---------------------------------------------------------------------------
# the grid mode (fp16: csrc/unet1d_grid.cuh)
# ---------------------------------------------------------------------------

GRID_ROWS = 64          # output rows of a grid-mode item at most
GRID_STAT_FLOATS = 2048  # a block's cache of GroupNorm statistics
GRID_MAX_GEMMS = 64     # rows of the launch's GEMM table (kGridMaxGemms)
GRID_ENTRY = "ldp_unet1d_sampler_f16_grid"
# a phase's fixed cost in the grid mode (its barrier, the ring's first
# stages and last drain, the window's copy, the statistics) in the bytes L2
# would move in its time: the grid kernel with every GEMM's products
# skipped took 106.8 ms for 6300 phases at the default LDP planner on one
# H100 (17 us each), 85 MB at 5 TB/s
GRID_BARRIER_BYTES = 85 << 20


@functools.lru_cache(maxsize=64)
def _grid_gemms(signature: tuple, T: int) -> tuple:
    """Every GEMM of the main stream in program order as the grid mode runs
    it: (name, input length, output length, N, taps, pad32(Cin), first
    tile, GroupNorm channels a group after it or 0, lo pass)."""
    lay = _layout(signature, torch.float16)
    gm = lay["gemm"]
    G = signature[5]
    out, Tl = [], T
    for op in _walk(len(signature[3]), signature[6]):
        names, Tin = [], Tl
        if op[0] == "film":
            names = [(f"conv1.{op[1]}", True), (f"conv2.{op[1]}", True),
                     (f"proj.{op[1]}", False)]
        elif op[0] in ("down", "up"):
            Tl = Tl // 2 if op[0] == "down" else 2 * Tl
            names = [(f"{op[0]}.{op[1]}", False)]
        elif op[0] == "final_block":
            names = [("final_block", True)]
        elif op[0] == "final_conv":
            names = [("final_conv", False)]
        for name, gn in names:
            if name not in gm:
                continue
            g = gm[name]
            out.append((name, Tin, Tl, g["cout"], g["taps"],
                        _up(g["cin"], TILE_K), g["tile_off"],
                        g["cout"] // G if gn else 0, name == "final_conv"))
    return tuple(out)


def grid_schedule(net: ConditionalUnet1D, B: int, T: int,
                  blocks: int = H100_SMS) -> list[dict]:
    return _grid_schedule(_signature(net), B, T, blocks)


@functools.lru_cache(maxsize=16)
def _grid_schedule(signature: tuple, B: int, T: int,
                   blocks: int = H100_SMS) -> list[dict]:
    """The grid mode's work, GEMM by GEMM in program order: each item's
    block, output rows [r0, r0 + rows) (whole samples: ``GRID_ROWS``, or
    half or a quarter of that where the items still fit one wave of
    ``blocks``), columns [c0, c0 +
    cols) (one 128-column group), K range [k0, k1) of taps × pad32(Cin)
    (all of it: a K sum is never split) and the weight tiles it reads (its
    column group's stripe, contiguous in the main stream); item i is column
    group i % n_col of row tile i // n_col, run by block i % blocks, as
    ``grid_gemm`` in ``csrc/unet1d_grid.cuh`` takes them (its rows an item
    from ``grid_table``)."""
    out = []
    for name, Tin, Tl, N, taps, cinp, tile0, gn_ch, lo in _grid_gemms(
            signature, T):
        M = B * Tl
        n_col = -(-N // TILE_N)
        # GRID_ROWS, halved (whole samples, 16 rows at least) while the
        # items still fit one wave of blocks
        rows = GRID_ROWS
        while (rows // 2 >= max(16, Tl)
               and -(-M // (rows // 2)) * n_col <= blocks):
            rows //= 2
        n_row = -(-M // rows)
        stripe = taps * cinp // TILE_K
        items = []
        for i in range(n_row * n_col):
            ng, r0 = i % n_col, i // n_col * rows
            items.append(dict(block=i % blocks, r0=r0,
                              rows=min(rows, M - r0), c0=ng * TILE_N,
                              cols=min(TILE_N, N - ng * TILE_N), k0=0,
                              k1=taps * cinp,
                              tiles=(tile0 + ng * stripe,
                                     tile0 + (ng + 1) * stripe)))
        out.append(dict(name=name, length_in=Tin, length=Tl, rows=M, N=N,
                        item_rows=rows, taps=taps, cin_pad=cinp,
                        K=taps * cinp,
                        gn_channels=gn_ch, lo_pass=lo, items=items))
    return out


def grid_fits(net: ConditionalUnet1D, B: int, T: int,
              dtype: torch.dtype = WEIGHT_DTYPE,
              blocks: int = H100_SMS) -> bool:
    """Whether the grid mode takes this call: fp16 weights, widths of whole
    16-byte runs, every level's length divides ``GRID_ROWS`` (an item
    holds whole samples), no GroupNorm group spans two 128-column groups,
    each block's share of an elementwise pass holds the statistics of few
    enough samples for its cache, and every item's input rows fit the
    window (``grid_pass``)."""
    if _check_dtype(dtype) != torch.float16:
        return False
    if any(ch % 8 for ch in net.down_dims):   # skips copied 16 bytes at once
        return False
    if len(_grid_gemms(_signature(net), T)) > GRID_MAX_GEMMS:
        return False
    for name, Tin, Tl, N, taps, cinp, tile0, gn_ch, lo in _grid_gemms(
            _signature(net), T):
        if GRID_ROWS % Tl:
            return False
        if gn_ch and N > TILE_N and TILE_N % gn_ch:
            return False
        per = -(-(B * Tl) // blocks)
        if 2 * (-(-per // Tl) + 1) * net.n_groups > GRID_STAT_FLOATS:
            return False
    return all(stages >= MIN_STAGES
               for _, _, stages, _ in grid_table(net, B, T, blocks))


def grid_pass(g: dict, space: int) -> tuple[int, int, int]:
    """(output rows a pass, ring stages, window bytes) of a GEMM of
    ``grid_schedule`` in ``space`` bytes of ring and window: its item's
    rows halved (whole samples) until its input rows (at pad32(Cin) + 8
    fp16 a row) fit beside two ring stages, the ring as deep as the rest
    allows (at most 8; fewer than 2 where one sample's rows do not fit,
    which ``grid_fits`` refuses)."""
    ldw = g["cin_pad"] + 8
    rows_in = lambda p: p // g["length"] * g["length_in"]
    stage = stage_bytes(torch.float16)
    room = space - MIN_STAGES * stage
    p = g["item_rows"]
    while p > g["length"] and 2 * rows_in(p) * ldw > room:
        p //= 2
    win = _up(2 * rows_in(p) * ldw, 128)
    return p, min(MAX_STAGES, (space - win) // stage), win


def grid_table(net: ConditionalUnet1D, B: int, T: int,
               blocks: int = H100_SMS) -> list[tuple[int, int, int, int]]:
    """What ``grid_gemm`` runs each GEMM of a step with, in program order:
    (output rows an item, output rows a pass, ring stages, window bytes),
    from ``grid_schedule`` and ``grid_pass``. The launch carries the table
    (``gdims``); the kernel derives none of it and refuses a launch whose
    table does not fit its shared memory."""
    space = grid_plan(net, B, T, blocks)["space"]
    return [(g["item_rows"], *grid_pass(g, space))
            for g in grid_schedule(net, B, T, blocks)]


def grid_dims(net: ConditionalUnet1D, B: int, T: int,
              blocks: int = H100_SMS) -> list[int]:
    """The grid launch's ``gdims``: blocks, shared memory bytes, the bytes
    of it for the ring and the window, the scratch offsets of ``grid_plan``,
    the GEMMs a step, then ``grid_table`` row by row."""
    plan = grid_plan(net, B, T, blocks)
    table = grid_table(net, B, T, blocks)
    o = plan["offsets"]
    return [plan["blocks"], plan["smem_bytes"], plan["space"],
            *(o[k] for k in ("x32", "y32", "xb", "yb", "skip", "xcur",
                             "stats", "bar")),
            len(table), *(v for row in table for v in row)]


def grid_traffic(net: ConditionalUnet1D, B: int, T: int) -> dict:
    """What the grid mode's blocks move a step, most of it through L2: the
    weight tiles its items read (each item its stripe once a pass, the
    final conv's twice; each tile comes from HBM once a step), and the
    activations, which the ordinary mode keeps in shared memory: each
    item's input rows into the window (or, past it, through it a run of
    channels a tap), its fp32 output and operand copy, and the elementwise
    pass after a GroupNorm (fp32 in and out, the residual, the operand
    copy); and its barriers."""
    weights = acts = 0
    for g, (_, rows, _, _) in zip(grid_schedule(net, B, T),
                                  grid_table(net, B, T)):
        lo, hi = g["items"][0]["tiles"]
        for it in g["items"]:
            passes = -(-it["rows"] // rows)
            weights += passes * (hi - lo) * TILE * 2 * (
                2 if g["lo_pass"] else 1)
            rows_in = it["rows"] // g["length"] * g["length_in"]
            acts += rows_in * g["cin_pad"] * 2
        acts += g["rows"] * g["N"] * (6 + (14 if g["gn_channels"] else 0))
    return dict(weight_bytes=weights, activation_bytes=acts,
                barriers=grid_barriers(net, T),
                hbm_weight_bytes=layout(net, torch.float16)["stream"]["main"][
                    "n_tiles"] * TILE * 2)


def grid_bytes(net: ConditionalUnet1D, B: int, T: int) -> int:
    """The grid mode's cost a step in bytes (``grid_traffic``), each phase
    (one a barrier) counted as the GRID_BARRIER_BYTES L2 moves in its
    fixed time."""
    t = grid_traffic(net, B, T)
    return (t["weight_bytes"] + t["activation_bytes"]
            + t["barriers"] * GRID_BARRIER_BYTES)


def grid_barriers(net: ConditionalUnet1D, T: int) -> int:
    """Grid-wide barriers a step: one after each GEMM, GroupNorm pass and
    concat, and one after the step's update (a save needs none)."""
    n = 1
    for op in _walk(len(net.down_dims), net.downsample):
        if op[0] == "film":
            n += 5 if f"proj.{op[1]}" in layout(net, torch.float16)[
                "gemm"] else 4
        elif op[0] in ("concat", "down", "up", "final_conv"):
            n += 1
        elif op[0] == "final_block":
            n += 2
    return n


def ordinary_bytes(net: ConditionalUnet1D, B: int, T: int,
                   dtype: torch.dtype = WEIGHT_DTYPE,
                   sms: int = H100_SMS) -> int:
    """Bytes of weights the ordinary mode's blocks stream a step: each of
    its blocks the whole main stream."""
    nb, _ = choose_tile(net, T, B, dtype, sms)
    return -(-B // nb) * layout(net, dtype)["stream"]["main"]["stages"] * \
        stage_bytes(dtype)


def choose_grid(net: ConditionalUnet1D, T: int, B: int,
                dtype: torch.dtype = WEIGHT_DTYPE,
                sms: int = H100_SMS) -> bool:
    """The grid mode where it fits and costs fewer bytes a step
    (``grid_bytes``) than the ordinary mode's blocks stream: the default
    calls at 256 samples (the default LDP planner: 15.6 GB against 9.3);
    the ordinary mode elsewhere: the bench planner, whose weights fit L2,
    and LDP-hier's chunk IDM at 1024 samples (4.4 GB against 5.4: its 17
    MB of weights fit L2 too, and 4000 phases a call cost more than its
    blocks' stream)."""
    return _choose_grid(_signature(net), T, B, _check_dtype(dtype), sms)


@functools.lru_cache(maxsize=64)
def _choose_grid(signature: tuple, T: int, B: int, dtype: torch.dtype,
                 sms: int) -> bool:
    with torch.device("meta"):
        net = ConditionalUnet1D(*signature)
    return (grid_fits(net, B, T, dtype, sms)
            and ordinary_bytes(net, B, T, dtype, sms)
            > grid_bytes(net, B, T))


def grid_plan(net: ConditionalUnet1D, B: int, T: int,
              blocks: int = H100_SMS) -> dict:
    """The grid mode's program (the records and buffer sizes of a tile of
    all ``B`` samples), its scratch (byte offsets of X32, Y32, Xb, Yb, the
    skips, the current sample, the statistics and the barrier) and its
    shared memory: a zero row, the statistics cache, and ``space`` bytes
    for the ring and the window (``grid_pass``)."""
    f16 = torch.float16
    prog = build_program(net, T, B, False, f16)
    off, o = {}, 0
    for key, n in (("x32", 4 * prog["max32"]), ("y32", 4 * prog["max32"]),
                   ("xb", 2 * prog["maxb"]), ("yb", 2 * prog["maxb"]),
                   ("skip", 2 * prog["skip_total"]
                    + 4 * prog["skip32_total"]),
                   ("xcur", 4 * B * T * net.input_dim),
                   ("stats", 4 * 2 * B * net.n_groups), ("bar", 8)):
        off[key] = o
        o = _up(o + n, 256)
    return dict(program=prog, offsets=off, scratch_bytes=o, blocks=blocks,
                smem_bytes=SMEM_LIMIT,
                space=SMEM_LIMIT - 32 - 4 * GRID_STAT_FLOATS)


@functools.lru_cache(maxsize=64)
def _records_on(signature: tuple, T: int, nb: int, wide: bool,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    prog = _build_program(signature, T, nb, wide, dtype)
    return torch.tensor(prog["records"], dtype=torch.int32).to(device)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through ``dtype`` and back to its own type."""
    return x.to(dtype).to(x.dtype) if torch.is_floating_point(x) else x


def _round_input(dtype, module, args):
    return tuple(_round(a, dtype) for a in args)


class _JaxGroupNorm(torch.nn.Module):
    """GroupNorm as the JAX kernel computes it in fp16: the mean and the
    variance (E[x^2] - E[x]^2) of x and x * x rounded to ``dtype`` (so x *
    x overflows to inf past 256), and a non-finite statistic of one group
    NaN in the sample's other groups (JAX's 0/1 broadcast matmuls: 0 x inf).
    Per sample, as the JAX kernel at ``batch_tile=1``."""

    def __init__(self, norm: torch.nn.GroupNorm, dtype: torch.dtype):
        super().__init__()
        self.norm, self.dtype = norm, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        G = self.norm.num_groups
        xs = x.reshape(B, G, -1)
        n = xs.shape[-1]
        mu = _round(xs, self.dtype).sum(-1) / n
        var = _round(xs * xs, self.dtype).sum(-1) / n - mu * mu
        stats = []
        for v in (mu, var):
            bad = ~torch.isfinite(v)
            others = bad.sum(-1, keepdim=True) - bad.int() > 0
            stats.append(torch.where(others, torch.nan, v)[..., None])
        y = (xs - stats[0]) * torch.rsqrt(stats[1] + self.norm.eps)
        return (y.reshape(B, C, T) * self.norm.weight[:, None]
                + self.norm.bias[:, None])


def _note_length(block, args):
    block.film.length = args[0].shape[-1]


def _round_film(dtype, film, args, out):
    """FiLM's scale and bias through ``dtype`` where the JAX kernel
    broadcasts them with a matmul: a width not a multiple of 128, at a
    level longer than 1."""
    if out.shape[-1] // 2 % 128 and film.length > 1:
        return _round(out, dtype)
    return out


def _round_down(dtype, conv, args, out):
    """The downsample's output through ``dtype`` where the JAX kernel
    selects its rows with a matmul (a width not a multiple of 128)."""
    return _round(out, dtype) if conv.out_channels % 128 else out


def fp32_twin(net: ConditionalUnet1D) -> ConditionalUnet1D:
    """The net computing in fp32, the function the fp32 kernel computes:
    the net itself, or a copy of one built with a bf16 ``compute_dtype``
    (whose own forward rounds where the Flax module does, which the kernel
    does not)."""
    if all(getattr(m, "compute_dtype", None) is None for m in net.modules()):
        return net
    out = copy.deepcopy(net)
    for m in out.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None
    return out


def rounding_twin(net: ConditionalUnet1D,
                  dtype: torch.dtype = WEIGHT_DTYPE) -> ConditionalUnet1D:
    """A copy of the net that rounds where the kernel of weight type
    ``dtype`` rounds, the function that kernel computes, for holding it
    against the twin. bf16: weights through bf16, and the input of every
    Conv1d, ConvTranspose1d and Linear through bf16 (products of bf16
    operands, fp32 sums, everything else fp32). fp16 rounds where the JAX
    kernel with ``dtype=float16`` rounds: the same, but for the final 1x1
    conv, which takes the fp32 activations; GroupNorm's statistics from
    x and x * x rounded (``_JaxGroupNorm``); FiLM's scale and bias and the
    downsample's output rounded at widths that are not a multiple of 128
    (where that kernel broadcasts or selects rows with a matmul)."""
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"no rounding twin for {dtype}: the fp32 kernel's "
                         f"twin is fp32_twin(net)")
    out = copy.deepcopy(fp32_twin(net))
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(dtype).float())
    jax16 = dtype == torch.float16
    for m in out.modules():
        if (isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d,
                           torch.nn.Linear))
                and not (jax16 and m is out.final_conv)):
            m.register_forward_pre_hook(functools.partial(_round_input, dtype))
    if jax16:
        for m in list(out.modules()):
            if isinstance(m, ConvBlock1D):
                m.norm = _JaxGroupNorm(m.norm, dtype)
            elif isinstance(m, FiLMResBlock1D):
                m.register_forward_pre_hook(_note_length)
                m.film.register_forward_hook(
                    functools.partial(_round_film, dtype))
        for m in out.downs:
            m.register_forward_hook(functools.partial(_round_down, dtype))
    return out


def unet1d_ddim_sample_plain(net: ConditionalUnet1D, global_cond: torch.Tensor,
                             x_init: torch.Tensor, timesteps: torch.Tensor,
                             coefs: torch.Tensor, clip_range: float = 1.0,
                             noise: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The kernel's plain twin: the same update, one net call per step
    (``noise`` (S, B, T, D) for DDPM, None for DDIM)."""
    with torch.no_grad():
        return dlib.sample_with_coefs(
            lambda x, t: net(x, t, global_cond), x_init.float(), timesteps,
            coefs, None if noise is None else noise.float(), clip_range)


def kernel_info(net: ConditionalUnet1D, B: int, T: int, n_steps: int,
                nb: int | None = None,
                dtype: torch.dtype = WEIGHT_DTYPE, *,
                wide: bool | None = None, sms: int = H100_SMS,
                grid: bool | None = None) -> dict:
    """What a launch at this shape looks like (``n_steps`` 100 for DDPM-100):
    tile, mode, grid, shared memory, the global scratch of wide mode and
    the bytes of weights its blocks stream in all; fp32 also the waves of
    blocks on ``sms`` SMs; the grid mode its items, barriers and the bytes
    of ``grid_traffic``. ``nb``, ``wide`` and ``grid`` override the plan as
    the wrapper takes them."""
    lay = layout(net, dtype)
    stage = stage_bytes(dtype)
    rows = COND_ROWS
    pro = (n_steps * lay["stream"]["time"]["stages"]
           + -(-B // rows) * lay["stream"]["cond"]["stages"]) * stage
    prologue = dict(film_t_bytes=4 * n_steps * lay["film_ld"],
                    prologue_cond_rows=rows,
                    prologue_grid=n_steps + -(-B // rows),
                    prologue_smem_bytes=prologue_smem_bytes(net, dtype))
    if grid is None:
        grid = nb is None and choose_grid(net, T, B, dtype, sms)
    if grid:
        plan = grid_plan(net, B, T, sms)
        t = grid_traffic(net, B, T)
        return dict(dtype=str(dtype).removeprefix("torch."), mode="grid",
                    samples_per_block=B, grid=plan["blocks"], wide=False,
                    smem_bytes=plan["smem_bytes"],
                    scratch_bytes=plan["scratch_bytes"],
                    ring_stages=sorted({s for _, _, s, _ in
                                        grid_table(net, B, T, sms)}),
                    items_per_step=sum(len(g["items"]) for g in
                                       grid_schedule(net, B, T, sms)),
                    barriers=n_steps * t["barriers"],
                    activation_bytes=n_steps * t["activation_bytes"],
                    hbm_weight_bytes=n_steps * t["hbm_weight_bytes"] + pro,
                    weight_bytes_streamed=n_steps * t["weight_bytes"] + pro,
                    **prologue)
    if nb is None:
        nb, prog = choose_tile(net, T, B, dtype, sms)
    else:
        if wide is None:
            wide = choose_tile(net, T, dtype=dtype)[1]["wide"]
        prog = build_program(net, T, nb, wide, dtype)
    grid = -(-B // nb)
    main = lay["stream"]["main"]["stages"] * stage
    extra = {"waves": -(-grid // sms)} if esize(dtype) == 4 else {}
    return dict(dtype=str(dtype).removeprefix("torch."),
                mode="wide" if prog["wide"] else "ordinary",
                samples_per_block=nb, grid=grid, smem_bytes=prog["smem_bytes"],
                wide=prog["wide"], scratch_bytes=grid * prog["scratch_bytes"],
                operands_global=prog.get("operands_global", False),
                stage_elems=prog.get("stage_elems", 0),
                ring_stages=prog["stages"], **prologue,
                weight_bytes_per_step_and_block=main,
                weight_bytes_streamed=grid * n_steps * main + pro, **extra)


def _dims(net: ConditionalUnet1D, B: int, T: int, S: int, nb: int,
          prog: dict, dtype: torch.dtype) -> list[int]:
    """The kernel's ``Dims`` (``csrc/unet1d.cuh``) for a launch."""
    lay = layout(net, dtype)
    st = lay["stream"]
    return [B, T, net.input_dim, net.global_cond_dim, net.dsed,
            net.kernel_size, net.n_groups, nb, prog["max32"], prog["maxb"],
            prog["skip_total"], len(prog["records"]), S, lay["film_total"],
            lay["film_ld"], st["main"]["stages"], st["time"]["tile_base"],
            st["time"]["stages"], st["cond"]["tile_base"],
            st["cond"]["stages"], lay["vec_base"],
            lay["gemm"]["time0"]["vec_off"], lay["gemm"]["time1"]["vec_off"],
            lay["gemm"]["film_t"]["vec_off"], prog["smem_bytes"],
            prologue_smem_bytes(net, dtype), prog["stages"], PROLOGUE_STAGES,
            TILE_N, COND_ROWS,
            int(prog["wide"]) + int(prog.get("operands_global", False)),
            prog["scratch_bytes"], COND_CHUNK, prog["skip32_total"]]


def fused_unet1d_ddim_sample(net: ConditionalUnet1D, global_cond: torch.Tensor,
                             x_init: torch.Tensor, timesteps: torch.Tensor,
                             coefs: torch.Tensor,
                             noise: torch.Tensor | None = None, *,
                             clip_range: float = 1.0,
                             packed: torch.Tensor | None = None,
                             nb: int | None = None,
                             wide: bool | None = None,
                             dtype: torch.dtype = WEIGHT_DTYPE,
                             grid: bool | None = None
                             ) -> torch.Tensor:
    """Reverse process: global_cond (B, Dc), x_init (B, T, D) → (B, T, D).

    coefs (S, 6) from ``ops.diffusion``, for any prediction type:
    ``ddim_coef_table`` with ``noise`` None, or ``ddpm_coef_table`` with
    ``noise`` (S, B, T, D), one draw per step (its s_var column scales it).
    CPU tensors run the plain twin (with the net's own weights); CUDA
    tensors launch the kernel with weights of ``dtype`` (bf16, fp16 or
    fp32; fp32 plans its waves on the card's SMs; fp16 runs the grid mode
    where ``choose_grid`` takes it). ``packed`` is ``pack_params(net,
    dtype)`` on the device; ``nb`` overrides the samples per block and,
    with it, ``wide`` the mode, and ``grid`` forces the grid mode on or off
    (for measurements). A launch the card refuses raises.
    """
    if x_init.device.type == "cpu":
        return unet1d_ddim_sample_plain(net, global_cond, x_init, timesteps,
                                        coefs, clip_range, noise)
    if x_init.device.type != "cuda":
        raise ValueError(f"unsupported device {x_init.device}")
    B, T, D = x_init.shape
    _check_dtype(dtype)
    check_supported(net, T, dtype)
    if D != net.input_dim or global_cond.shape != (B, net.global_cond_dim):
        raise ValueError("sample or condition width does not match the net")
    dev = x_init.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if grid is None:
        grid = nb is None and choose_grid(net, T, B, dtype, sms)
    if grid:
        if not grid_fits(net, B, T, dtype, sms):
            raise ValueError("the grid mode does not take this call")
        nb, prog = B, grid_plan(net, B, T, sms)["program"]
    elif nb is None:
        nb, prog = choose_tile(net, T, B, dtype, sms)
    else:
        if wide is None:
            wide = choose_tile(net, T, dtype=dtype)[1]["wide"]
        prog = build_program(net, T, nb, wide, dtype)
        if (not rows_fit(nb, T, wide, dtype)
                or prog["smem_bytes"] > SMEM_LIMIT):
            raise ValueError(f"a tile of {nb} samples does not fit a block")
    lay = layout(net, dtype)
    if packed is None:
        packed = pack_params(net, dtype).to(dev)
    if packed.dtype != dtype or packed.numel() != lay["numel"]:
        raise ValueError(f"packed weights are not pack_params(net, {dtype})")
    if packed.data_ptr() % 16:
        raise ValueError("packed weights must be 16-byte aligned")
    S = int(timesteps.shape[0])
    if tuple(coefs.shape) != (S, 6):
        raise ValueError(f"coefs must be the (S, 6) table of "
                         f"ops.diffusion, got {tuple(coefs.shape)}")
    if noise is not None:
        if tuple(noise.shape) != (S, B, T, D):
            raise ValueError(f"noise must be {(S, B, T, D)}, got "
                             f"{tuple(noise.shape)}")
        if noise.device != x_init.device:
            raise ValueError("noise is not on the sample's device")
        noise = noise.float().contiguous()
    recs = _records_on(_signature(net), T, nb, prog["wide"], dtype, dev)
    gcond = global_cond.float().contiguous()
    x_init = x_init.float().contiguous()
    ts = timesteps.to(dev, torch.int32).contiguous()
    coefs = coefs.to(dev, torch.float32).contiguous()
    out = torch.empty((B, T, D), device=dev, dtype=torch.float32)
    # scratch the prologue fills: FiLM's time half per step (S of them: 100
    # for DDPM-100), and its global-condition half per sample
    film_t = torch.empty((S, lay["film_ld"]), device=dev, dtype=torch.float32)
    rows = COND_ROWS
    film_g = torch.empty((_up(B, rows), lay["film_ld"]), device=dev,
                         dtype=torch.float32)
    dims = torch.tensor(_dims(net, B, T, S, nb, prog, dtype),
                        dtype=torch.int32)
    P, I, F = _build.P, _build.I, _build.F
    args = [gcond.data_ptr(), x_init.data_ptr(), ts.data_ptr(),
            coefs.data_ptr(), _build.ptr(noise), packed.data_ptr(),
            recs.data_ptr(), film_t.data_ptr(), film_g.data_ptr()]
    if grid:
        plan = grid_plan(net, B, T, sms)
        scratch = torch.empty(plan["scratch_bytes"], device=dev,
                              dtype=torch.uint8)
        gdims = torch.tensor(grid_dims(net, B, T, sms), dtype=torch.int64)
        entry = GRID_ENTRY
        fn = _build.function(entry, [P] * 12 + [I, P, I, F, P])
        err = fn(*args, scratch.data_ptr(), out.data_ptr(), dims.data_ptr(),
                 dims.numel(), gdims.data_ptr(), gdims.numel(),
                 float(clip_range), _build.stream_ptr(x_init))
        fused_unet1d_ddim_sample.grid_launches += 1
    else:
        blocks = -(-B // nb)
        # wide mode: each block's fp32 buffers and skips
        scratch = (torch.empty(blocks * prog["scratch_bytes"], device=dev,
                               dtype=torch.uint8) if prog["wide"] else None)
        entry = ENTRIES[dtype]
        fn = _build.function(entry, [P] * 12 + [I, F, P])
        err = fn(*args, _build.ptr(scratch), out.data_ptr(), dims.data_ptr(),
                 dims.numel(), float(clip_range), _build.stream_ptr(x_init))
    _build.check(entry, err)
    fused_unet1d_ddim_sample.launches += 1
    return out


fused_unet1d_ddim_sample.launches = 0
# of those, the grid mode's (fp16)
fused_unet1d_ddim_sample.grid_launches = 0
