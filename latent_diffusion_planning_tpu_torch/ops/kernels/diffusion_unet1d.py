"""Fused DDIM sampler for ConditionalUnet1D: CUDA kernel + plain twin.

Replaces the TPU kernel ``latent_diffusion_planning_tpu/ops/pallas/
diffusion_unet1d.py`` (``fused_unet1d_ddim_sample`` → ``_kernel``, both its
VMEM-resident and its streamed-weights mode). The kernel
(``csrc/diffusion_unet1d.cu``) runs every η=0 DDIM step of the planner U-Net
for a tile of samples in one launch, with bf16 weights and fp32 activations
and accumulation. Its bound is the bf16 tensor-core rate; this design runs
the products as fp32 FMAs on the CUDA cores, which limit it, then the L2
reads of the weights. It keeps every activation and skip of the tile in
shared memory for all steps (see the source's note).

The net reaches the kernel as one packed weight buffer plus a small program
of 8-int records (``build_program``), so any ``down_dims``, ``n_groups`` and
embedding width runs through the same kernel. The twin computes the same
update with the module's own weights; to hold the kernel against it on the
card, give the twin a copy of the net whose weights are rounded to bf16
(``round_weights``).
"""

from __future__ import annotations

import copy

import torch

from ...models.nets.unet1d import ConditionalUnet1D
from .. import diffusion as dlib
from . import _build

SMEM_LIMIT = 232448     # bytes of shared memory one block may use on H100
NB_CHOICES = (8, 4, 2, 1)
WEIGHT_DTYPE = torch.bfloat16   # what the kernel reads its weights as

FILM, SAVE, CONCAT, DOWN, UP, FINAL_BLOCK, FINAL_CONV = range(7)


def check_supported(net: ConditionalUnet1D, T: int) -> None:
    """Raise ValueError, with the reason, for a call the kernel cannot run."""
    stride = 2 ** (len(net.down_dims) - 1)
    if T % stride:
        raise ValueError(f"plan length {T} not divisible by the U-Net stride "
                         f"{stride}")
    if any(ch % net.n_groups for ch in net.down_dims):
        raise ValueError("every down_dims entry must divide into n_groups")
    if net.kernel_size % 2 == 0:
        raise ValueError("kernel needs an odd kernel_size")


def _conv_kio(conv: torch.nn.Conv1d) -> torch.Tensor:
    """torch (Cout, Cin, k) → the kernel's (k, Cin, Cout)."""
    return conv.weight.permute(2, 1, 0)


def _block_params(blk) -> list[torch.Tensor]:
    return [_conv_kio(blk.conv), blk.conv.bias, blk.norm.weight, blk.norm.bias]


def _groups(net: ConditionalUnet1D) -> list[tuple[str, list[torch.Tensor]]]:
    """The net's weights in the kernel's order, as named groups; a group's
    offset in the packed buffer is that of its first tensor."""
    groups = [("time", [net.time_dense0.weight.t(), net.time_dense0.bias,
                        net.time_dense1.weight.t(), net.time_dense1.bias])]
    for i, blk in enumerate(net.blocks):
        groups += [(f"conv1.{i}", _block_params(blk.block0)),
                   (f"conv2.{i}", _block_params(blk.block1)),
                   (f"film.{i}", [blk.film.weight.t(), blk.film.bias])]
        if blk.proj is not None:
            groups.append((f"proj.{i}", [_conv_kio(blk.proj), blk.proj.bias]))
    for i, conv in enumerate(net.downs):
        groups.append((f"down.{i}", [_conv_kio(conv), conv.bias]))
    for i, up in enumerate(net.ups):
        # stored flipped for torch's conv_transpose1d; the kernel takes the
        # Flax taps, x[t] w[j] -> y[2t+2-j]
        groups.append((f"up.{i}", [up.weight.flip(-1).permute(2, 0, 1),
                                   up.bias]))
    groups.append(("final_block", _block_params(net.final_block)))
    groups.append(("final_conv", [_conv_kio(net.final_conv),
                                  net.final_conv.bias]))
    return groups


def pack_params(net: ConditionalUnet1D) -> torch.Tensor:
    """Every weight of the net in the kernel's order, cast to bf16."""
    return torch.cat([p.detach().reshape(-1).to(WEIGHT_DTYPE)
                      for _, group in _groups(net) for p in group])


def build_program(net: ConditionalUnet1D, T: int, nb: int) -> dict:
    """The kernel's op records and its shared-memory layout for a tile of
    ``nb`` samples of length ``T``."""
    off = {}
    o = 0
    for name, group in _groups(net):
        off[name] = o
        o += sum(p.numel() for p in group)
    dd = list(net.down_dims)
    L = len(dd)
    D = net.input_dim
    recs = []
    maxs = T * D                       # largest activation, floats per sample
    n_blk = 0

    def film(cin, ch, Tl):
        nonlocal maxs, n_blk
        i = n_blk
        n_blk += 1
        recs.append([FILM, cin, ch, Tl, off[f"conv1.{i}"], off[f"conv2.{i}"],
                     off[f"film.{i}"], off.get(f"proj.{i}", -1)])
        maxs = max(maxs, Tl * cin, Tl * ch)

    # one skip slot per level >= 1 (the level-0 skip is never read back)
    slot, skip_total = {}, 0
    for i in range(1, L):
        slot[i] = skip_total
        skip_total += nb * (T >> i) * dd[i]

    Tl, cin = T, D
    for i, ch in enumerate(dd):
        film(cin, ch, Tl)
        film(ch, ch, Tl)
        cin = ch
        if i:
            recs.append([SAVE, slot[i], ch, Tl, 0, 0, 0, 0])
        if i < L - 1:
            recs.append([DOWN, ch, Tl, off[f"down.{i}"], 0, 0, 0, 0])
            Tl //= 2
    film(cin, cin, Tl)
    film(cin, cin, Tl)
    for j, (lvl, ch) in enumerate(zip(range(L - 1, 0, -1),
                                      reversed(dd[:-1]))):
        recs.append([CONCAT, slot[lvl], cin, dd[lvl], Tl, 0, 0, 0])
        film(cin + dd[lvl], ch, Tl)
        film(ch, ch, Tl)
        cin = ch
        recs.append([UP, ch, Tl, off[f"up.{j}"], 0, 0, 0, 0])
        Tl *= 2
        maxs = max(maxs, Tl * ch)
    recs.append([FINAL_BLOCK, dd[0], dd[0], T, off["final_block"], 0, 0, 0])
    recs.append([FINAL_CONV, dd[0], D, T, off["final_conv"], 0, 0, 0])

    d = net.dsed
    cond_dim = d + net.global_cond_dim
    film_max = 2 * max(dd)
    # the zero row that out-of-sample conv taps read: the widest conv input
    cin_max = max([D, *dd] + [r[1] for r in recs if r[0] == FILM])
    floats = (nb * T * D + 3 * nb * maxs + skip_total + nb * net.global_cond_dim
              + 6 * d + nb * cond_dim + nb * film_max + nb * net.n_groups * 2
              + cin_max)
    return dict(records=recs, maxs=maxs, skip_total=skip_total,
                film_max=film_max, cin_max=cin_max, smem_bytes=4 * floats)


def choose_tile(net: ConditionalUnet1D, T: int) -> tuple[int, dict]:
    for nb in NB_CHOICES:
        prog = build_program(net, T, nb)
        if prog["smem_bytes"] <= SMEM_LIMIT:
            return nb, prog
    raise ValueError("net too wide for the kernel's shared memory")


def round_weights(net: ConditionalUnet1D) -> ConditionalUnet1D:
    """A copy of the net whose weights are rounded through bf16 — the
    function the kernel computes, for holding it against the twin."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(WEIGHT_DTYPE).float())
    return out


def unet1d_ddim_sample_plain(net: ConditionalUnet1D, global_cond: torch.Tensor,
                             x_init: torch.Tensor, timesteps: torch.Tensor,
                             coefs: torch.Tensor,
                             clip_range: float = 1.0) -> torch.Tensor:
    """The kernel's plain twin: the same update, one net call per step."""
    with torch.no_grad():
        return dlib.sample_with_coefs(
            lambda x, t: net(x, t, global_cond), x_init.float(), timesteps,
            coefs, None, clip_range)


def fused_unet1d_ddim_sample(net: ConditionalUnet1D, global_cond: torch.Tensor,
                             x_init: torch.Tensor, timesteps: torch.Tensor,
                             coefs: torch.Tensor, *, clip_range: float = 1.0,
                             packed: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """DDIM reverse process: global_cond (B, Dc), x_init (B, T, D) → (B, T, D).

    coefs (S, 5) from ``ops.diffusion.ddim_coef_table`` (the s_var column is
    ignored: η = 0). CPU tensors run the plain twin (with the net's own
    weights); CUDA tensors launch the kernel with bf16 weights.
    ``packed`` is ``pack_params(net)`` on the device.
    """
    if x_init.device.type == "cpu":
        return unet1d_ddim_sample_plain(net, global_cond, x_init, timesteps,
                                        coefs, clip_range)
    if x_init.device.type != "cuda":
        raise ValueError(f"unsupported device {x_init.device}")
    B, T, D = x_init.shape
    check_supported(net, T)
    if D != net.input_dim or global_cond.shape != (B, net.global_cond_dim):
        raise ValueError("sample or condition width does not match the net")
    nb, prog = choose_tile(net, T)
    dev = x_init.device
    if packed is None:
        packed = pack_params(net).to(dev)
    if packed.dtype != WEIGHT_DTYPE:
        raise ValueError("the kernel reads bf16 weights")
    recs = torch.tensor(prog["records"], dtype=torch.int32).to(dev)
    gcond = global_cond.float().contiguous()
    x_init = x_init.float().contiguous()
    ts = timesteps.to(dev, torch.int32).contiguous()
    coefs = coefs.to(dev, torch.float32).contiguous()
    out = torch.empty((B, T, D), device=dev, dtype=torch.float32)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("ldp_unet1d_sampler",
                         [P, P, P, P, P, P, I, P] + [I] * 13 + [F, I, P])
    err = fn(gcond.data_ptr(), x_init.data_ptr(), ts.data_ptr(),
             coefs.data_ptr(), packed.data_ptr(), recs.data_ptr(),
             len(prog["records"]), out.data_ptr(), B, T, D,
             net.global_cond_dim, net.dsed, net.kernel_size, net.n_groups, nb,
             prog["maxs"], prog["skip_total"], prog["film_max"],
             int(ts.shape[0]), prog["cin_max"], float(clip_range),
             prog["smem_bytes"],
             _build.stream_ptr(x_init))
    _build.check("ldp_unet1d_sampler", err)
    fused_unet1d_ddim_sample.launches += 1
    return out


fused_unet1d_ddim_sample.launches = 0
