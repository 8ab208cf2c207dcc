"""Fused reverse-diffusion sampler for the MLP IDM: CUDA kernel + plain twin.

Replaces the TPU kernel ``latent_diffusion_planning_tpu/ops/pallas/
diffusion_mlp.py`` (``fused_mlp_diffusion_sample`` → ``_sampler_kernel``).
The kernel (``csrc/diffusion_mlp.cu``) runs the whole DDPM/DDIM reverse
process of ``MLPDiffusion`` in one launch with fp32 results. Its three large
products per residual block run on the tensor cores as error-compensated
TF32 (each operand split ``hi + lo``, ``hi·hi + hi·lo + lo·hi`` summed in
fp32), which keeps about fp32's accuracy where plain TF32 would not. On the
card it is bound by those three tensor-core passes and, about as long, by the
weight stream: every 64-row block reads all the weights (6.4 MB at the bench
widths) from L2 once per step. A block holds 64 rows, or 32 where a wide
condition's 64-row ``[x|s]`` tile would leave the weight ring fewer than two
stages of shared memory (``_smem``): the ALOHA recipe's IDM conditions on
two 270-wide observations (S = 540) and runs 32 rows a block. A row too
wide for either (``chunked``) is walked in 16-column chunks: the block keeps
only x and one chunk of ``[x|s]`` in shared memory and reads s from global
memory chunk by chunk as the trunk input layer streams its weights, the same
products in the same order. Every ``MLPDiffusion`` variant runs: any cond
MLP (depth, widths, relu, swish, mish or gelu), fixed or learnable time
features, LayerNorm or none, and any hidden width up to ``MAX_HIDDEN``,
padded to whole 64-column tiles (128 past 256, where a block holds 32 rows
and the 4h layer runs in eight passes; 256 past 512, where a block holds 16
rows and the 4h layer runs in passes of 256 columns; 1536 past 1024, where
a ring stage holds 8 K-rows instead of 16). The design keeps the
residual in registers as
the products' accumulator for all steps, keeps only the products' left
operands in shared memory, and streams the weights, pre-tiled here in the
order and fragment layout the kernel consumes, through a shared-memory ring
of asynchronous copies (see the source's note).

Packed layout (``pack_params``), one fp32 buffer: ``[ stream | vectors ]``.
The stream holds, per step, the trunk input layer's ``[x|s]`` rows (K padded
to 16) and then, per block and per pass ``c`` of the 4H layer (``passes``
of ``4 Hp / passes`` columns), ``w0[:, c]`` and ``w1[c, :]``; each (K, N)
matrix as tiles of 16 K-rows in ``mma`` B-fragment order (``tile_matrix``),
Hp wide or narrower (a ring stage holds ``stage_rows`` × Hp floats).
``vectors`` holds everything the CUDA cores read: the time path (the
Fourier frequencies and every cond layer), biases, LayerNorm and the output
layer. Every padded row, column and vector entry is zero.

The caller supplies the initial sample, every step's noise (None for DDIM)
and the (T, 6) coefficient table from ``ops.diffusion`` (any prediction
type), so kernel and twin consume identical draws.
"""

from __future__ import annotations

import torch

from ...models.nets.embeddings import sinusoidal_freqs
from ...models.nets.mlp import MLPDiffusion
from .. import diffusion as dlib
from . import _build

ROW_CHOICES = (64, 32)  # the kernel's instances, widest first (Hp <= 256)
STAGE_K = 16            # K-rows per ring stage
MAX_STAGES = 8
SMEM_LIMIT = 232448     # bytes of shared memory one block may use on H100
MAX_HIDDEN = 1536       # past 1024 a ring stage holds 8 K-rows of Hp 1536
PASS_COLS = 256         # columns of a 4H pass past a padded width of 512
MAX_COND_LAYERS = 16
ACTIVATIONS = ("relu", "swish", "mish", "gelu")   # the time kernel's codes


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def hidden(net: MLPDiffusion) -> int:
    return net.trunk.dense0.out_features


def padded(H: int) -> int:
    """The width the kernel runs a hidden width at: whole 64-column tiles
    (eight warps of 8-column ``mma`` tiles), past 256 whole 128-column ones,
    so each of the eight passes over the 4H layer is whole tiles, and past
    512 whole 256-column ones, so a stage holds whole passes of w0; past
    1024 the one wider instance, 1536."""
    if H <= 256:
        return _up(H, 64)
    if H > 1024:
        return MAX_HIDDEN
    return _up(H, 128) if H <= 512 else _up(H, PASS_COLS)


def stage_rows(Hp: int) -> int:
    """K-rows of a ring stage: 16 (16 × Hp floats), 8 past 1024 (a stage of
    16 × 1536 floats would leave no room for two beside the LayerNorm
    output); the stream is the same."""
    return STAGE_K if Hp <= 1024 else STAGE_K // 2


def passes(Hp: int) -> int:
    """Passes over the 4H layer: 4 of Hp columns, 8 of Hp / 2 past 256, and
    Hp / 64 of ``PASS_COLS`` past 512 (one pass's accumulator stays at most
    32 registers a thread)."""
    if Hp <= 256:
        return 4
    return 8 if Hp <= 512 else 4 * Hp // PASS_COLS


def row_choices(Hp: int) -> tuple[int, ...]:
    """Rows a block may hold at a padded width, most first: the residual
    lives in registers, 64 x Hp floats up to 256, then 32 and 16 rows."""
    if Hp <= 256:
        return ROW_CHOICES
    return (32,) if Hp <= 512 else (16,)


def check_supported(net: MLPDiffusion) -> None:
    """Raise ValueError, with the reason, for a net the kernel cannot run."""
    if net.time.learnable and net.time.kernel.shape[1] != 1:
        raise ValueError("kernel needs a scalar time input to its Fourier "
                         "features")
    if net.cond_activation not in ACTIVATIONS:
        raise ValueError(f"kernel takes a cond MLP activation of "
                         f"{ACTIVATIONS}, net has {net.cond_activation!r}")
    if len(net.cond.dense) > MAX_COND_LAYERS:
        raise ValueError(f"kernel takes a cond MLP of up to "
                         f"{MAX_COND_LAYERS} layers")
    if not net.cond.plain:
        raise ValueError("kernel takes the cond MLP the JAX MLPDiffusion "
                         "builds (no LayerNorm, final activation or tanh)")
    H = hidden(net)
    if H > MAX_HIDDEN:
        raise ValueError(f"kernel needs a hidden_dim up to {MAX_HIDDEN}, net "
                         f"has {H}")


def tile_matrix(w: torch.Tensor) -> torch.Tensor:
    """(K, H) → flat tiles of 16 K-rows (K padded with zero rows; H a
    multiple of 64). Inside a tile element (k, n) sits at ``[k // 8]
    [n // (H/8)][n % (H/8) // 8][(n % 8) * 4 + k % 4][k % 8 // 4]`` of a
    (2, 8 warps, H/64 tiles, 32 lanes, 2) block: lane ``l`` of warp ``w``
    reads the ``m16n8k8`` B fragment of each of its column tiles as one
    8-byte word."""
    K, H = w.shape
    nt = H // 64
    Kp = _up(K, STAGE_K)
    full = w.new_zeros((Kp, H))
    full[:K] = w
    # k = stage*16 + k8*8 + e*4 + tq ; n = warp*8*nt + t*8 + g
    v = full.reshape(Kp // 16, 2, 2, 4, 8, nt, 8)
    #      dims:     stage   k8 e  tq warp t  g
    return v.permute(0, 1, 4, 5, 6, 3, 2).reshape(-1)


def untile_matrix(flat: torch.Tensor, K: int, H: int) -> torch.Tensor:
    """Inverse of ``tile_matrix``: the padded (pad16(K), H) matrix."""
    nt = H // 64
    Kp = _up(K, STAGE_K)
    v = flat.reshape(Kp // 16, 2, 8, nt, 8, 4, 2)
    return v.permute(0, 1, 6, 5, 2, 3, 4).reshape(Kp, H)


def _pad(w: torch.Tensor, rows: int | None, cols: int | None = None
         ) -> torch.Tensor:
    """``w`` (a matrix, or a vector with ``cols`` None) zero-padded."""
    if w.ndim == 1:
        out = w.new_zeros(rows)
        out[:w.shape[0]] = w
        return out
    out = w.new_zeros((rows or w.shape[0], cols))
    out[:w.shape[0], :w.shape[1]] = w
    return out


def pass_cols(H: int) -> tuple[int, int]:
    """(real, padded) columns of a pass over the 4H layer: the 4H real
    columns cut into ``passes`` runs of ``ceil(4H / passes)`` (the last
    shorter), each padded to ``4 Hp / passes``."""
    nc = passes(padded(H))
    return -(-4 * H // nc), 4 * padded(H) // nc


def _stream(net: MLPDiffusion) -> list[tuple[str, torch.Tensor]]:
    """The padded (K, N) matrices of one step in the order the kernel
    consumes them."""
    H = hidden(net)
    Hp = padded(H)
    nc = passes(Hp)
    hr, hc = pass_cols(H)                   # a pass's real and padded width
    n_in = net.out_dim + net.s_dim
    out = [("trunk_in", _pad(net.trunk.dense0.weight.t()[:n_in], None, Hp))]
    for b, blk in enumerate(net.trunk.blocks):
        w0, w1 = blk.dense0.weight.t(), blk.dense1.weight.t()  # (H,4H) (4H,H)
        for c in range(nc):
            out += [(f"w0.{b}.{c}", _pad(w0[:, c * hr:(c + 1) * hr], Hp, hc)),
                    (f"w1.{b}.{c}", _pad(w1[c * hr:(c + 1) * hr], hc, Hp))]
    return out


def time_freqs(net: MLPDiffusion) -> torch.Tensor:
    """The Fourier features' frequencies: the learnable kernel's, or the
    fixed sinusoidal ones (which scale t without 2π)."""
    if net.time.learnable:
        return net.time.kernel[:, 0]
    return sinusoidal_freqs(net.time.output_size,
                            net.trunk.dense0.weight.device)


def _vectors(net: MLPDiffusion) -> list[tuple[str, torch.Tensor]]:
    H = hidden(net)
    Hp = padded(H)
    nc = passes(Hp)
    hr, hc = pass_cols(H)
    n_in = net.out_dim + net.s_dim
    parts = [("ff", time_freqs(net))]
    for i, lin in enumerate(net.cond.dense):
        parts += [(f"cw.{i}", lin.weight.t()), (f"cb.{i}", lin.bias)]
    parts += [("twc", _pad(net.trunk.dense0.weight.t()[n_in:], None, Hp)),
              ("tb0", _pad(net.trunk.dense0.bias, Hp))]
    for b, blk in enumerate(net.trunk.blocks):
        if net.use_layer_norm:
            ln_s, ln_b = blk.norm.weight, blk.norm.bias
        else:
            ln_s = ln_b = blk.dense1.bias.new_zeros(H)
        b0 = torch.cat([_pad(blk.dense0.bias[c * hr:(c + 1) * hr], hc)
                        for c in range(nc)])
        parts += [(f"blk.{b}", torch.cat([_pad(ln_s, Hp), _pad(ln_b, Hp), b0,
                                          _pad(blk.dense1.bias, Hp)]))]
    return parts + [("ow", _pad(net.trunk.dense1.weight.t(), Hp,
                                net.out_dim)),
                    ("ob", net.trunk.dense1.bias)]


def layout(net: MLPDiffusion) -> dict:
    """Offsets (floats) of every streamed matrix, the stages a step streams,
    where the vectors start and, from there, the blocks and the output
    layer."""
    Hp = padded(hidden(net))
    off, o = {}, 0
    for name, w in _stream(net):
        off[name] = o
        o += _up(w.shape[0], STAGE_K) * w.shape[1]
    voff, v = {}, 0
    for name, p in _vectors(net):
        voff[name] = v
        v += p.numel()
    return dict(offsets=off, stream_stages=o // (stage_rows(Hp) * Hp),
                vec_base=o,
                vec_offsets=voff, numel=o + v, Hp=Hp, passes=passes(Hp))


def pack_params(net: MLPDiffusion) -> torch.Tensor:
    """The net's weights, fp32, tiled and ordered as the kernel consumes
    them (see the module docstring)."""
    check_supported(net)
    with torch.no_grad():
        parts = [tile_matrix(w.detach().float()) for _, w in _stream(net)]
        parts += [p.detach().float().reshape(-1) for _, p in _vectors(net)]
        return torch.cat(parts)


def _smem(net: MLPDiffusion, A: int, S: int) -> dict:
    """Rows a block, its shared memory and the ring's stages. The whole
    ``[x|s]`` row in shared memory at the most rows (``row_choices``) where
    the ring keeps at least two stages beside it; else ``chunked``: at the
    most rows, only x and one 16-column chunk of the row (``kxs`` is then the
    chunk's row stride), whatever S is."""
    H = padded(hidden(net))
    hc = 4 * H // passes(H)
    stage = stage_rows(H) * H * 4
    rowsets = row_choices(H)

    def plan(rows, chunked):
        kxs = (STAGE_K if chunked else _up(A + S, STAGE_K)) + 4
        rest = 4 * (rows * kxs + rows * (H + 4) + rows * (hc + 4) + rows * 8
                    + rows * A * (2 if chunked else 1))
        stages = min(MAX_STAGES, (SMEM_LIMIT - rest) // stage)
        return dict(rows=rows, kxs=kxs, stages=stages, chunked=chunked,
                    smem_bytes=stages * stage + rest)

    for rows in rowsets:
        p = plan(rows, False)
        if p["stages"] >= 2:
            return p
    p = plan(rowsets[0], True)
    if p["stages"] < 2:
        raise ValueError(f"hidden {H} leaves the weight ring under two "
                         f"{stage}-byte stages of {SMEM_LIMIT} bytes")
    return p


def kernel_info(net: MLPDiffusion, N: int, A: int, S: int, T: int) -> dict:
    """What a launch at this shape looks like: tile, grid, shared memory and
    the bytes of weights its blocks stream in all (a net the kernel cannot
    run raises with the reason)."""
    check_supported(net)
    H = padded(hidden(net))
    sm = _smem(net, A, S)
    grid = -(-N // sm["rows"])
    per_step = layout(net)["stream_stages"] * stage_rows(H) * H * 4
    return dict(rows_per_block=sm["rows"], grid=grid, hidden_padded=H,
                passes=passes(H), chunked=sm["chunked"],
                layer_norm=net.use_layer_norm,
                smem_bytes=sm["smem_bytes"],
                ring_stages=sm["stages"],
                weight_bytes_per_step_and_block=per_step,
                weight_bytes_streamed=grid * T * per_step)


def mlp_diffusion_sample_plain(net: MLPDiffusion, s: torch.Tensor,
                               x_init: torch.Tensor, timesteps: torch.Tensor,
                               coefs: torch.Tensor, noise: torch.Tensor | None,
                               clip_range: float = 1.0) -> torch.Tensor:
    """The kernel's plain twin: the same update, one net call per step."""
    with torch.no_grad():
        return dlib.sample_with_coefs(lambda a, t: net(s, a, t), x_init.float(),
                                      timesteps, coefs, noise, clip_range)


def fused_mlp_diffusion_sample(net: MLPDiffusion, s: torch.Tensor,
                               x_init: torch.Tensor, timesteps: torch.Tensor,
                               coefs: torch.Tensor,
                               noise: torch.Tensor | None = None, *,
                               clip_range: float = 1.0,
                               packed: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Run the full reverse process for (N, S) conditions → (N, A) fp32.

    timesteps (T,) descending; coefs (T, 6) from ``ops.diffusion``; noise
    (T, N, A) or None (DDIM).
    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    ``packed`` is ``pack_params(net)`` on the device, to reuse across calls.
    """
    if s.device.type == "cpu":
        return mlp_diffusion_sample_plain(net, s, x_init, timesteps, coefs,
                                          noise, clip_range)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    check_supported(net)
    N, S = s.shape
    A = x_init.shape[1]
    T = int(timesteps.shape[0])
    half = net.time_dim // 2
    widths = [lin.out_features for lin in net.cond.dense]
    H = hidden(net)
    if net.trunk.dense0.in_features != A + S + widths[-1]:
        raise ValueError("condition width does not match the net")
    if noise is not None and tuple(noise.shape) != (T, N, A):
        raise ValueError(f"noise must be {(T, N, A)}, got {tuple(noise.shape)}")
    if tuple(coefs.shape) != (T, 6):
        raise ValueError(f"coefs must be the (T, 6) table of ops.diffusion, "
                         f"got {tuple(coefs.shape)}")
    sm = _smem(net, A, S)
    lay = layout(net)
    dev = s.device
    if packed is None:
        packed = pack_params(net).to(dev)
    if packed.dtype != torch.float32 or packed.numel() != lay["numel"]:
        raise ValueError("packed weights are not pack_params(net) in fp32")
    s = s.float().contiguous()
    x_init = x_init.float().contiguous()
    ts = timesteps.to(dev, torch.int32).contiguous()
    coefs = coefs.to(dev, torch.float32).contiguous()
    if noise is not None:
        noise = noise.float().contiguous()
    out = torch.empty((N, A), device=dev, dtype=torch.float32)
    # scratch the prologue fills: the time's share of the trunk input layer
    Hp = lay["Hp"]
    cbias = torch.empty((T, Hp), device=dev, dtype=torch.float32)
    maxw = max(2 * half, *widths)
    vo = lay["vec_offsets"]
    dims = torch.tensor(
        [N, S, A, T, half, H, Hp, len(net.trunk.blocks), sm["kxs"],
         sm["stages"], lay["stream_stages"], lay["vec_base"],
         sm["smem_bytes"], 8 * maxw, sm["rows"], int(net.use_layer_norm),
         len(widths), ACTIVATIONS.index(net.cond_activation),
         int(net.time.learnable), maxw, vo.get("blk.0", vo["ow"]), vo["ow"],
         int(sm["chunked"]), *widths, *[0] * (MAX_COND_LAYERS - len(widths))],
        dtype=torch.int32)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("ldp_mlp_sampler", [P] * 9 + [I, F, P])
    err = fn(s.data_ptr(), x_init.data_ptr(), ts.data_ptr(), coefs.data_ptr(),
             _build.ptr(noise), packed.data_ptr(), cbias.data_ptr(),
             out.data_ptr(), dims.data_ptr(), dims.numel(), float(clip_range),
             _build.stream_ptr(s))
    _build.check("ldp_mlp_sampler", err)
    fused_mlp_diffusion_sample.launches += 1
    return out


fused_mlp_diffusion_sample.launches = 0
