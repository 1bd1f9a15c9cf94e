"""Grouped routed experts of a DeepSeek-V2 decode call: CUDA kernel and plain
version.

`moe_experts` computes the routed-expert sum of `models/deepseek_v2.py`'s
expert layer for a call of at most `DENSE_MAX_TOKENS` tokens (every decode
step):

    out[n, :] = sum_e w[n, e] * (silu(h[n] @ G_e) * (h[n] @ U_e)) @ D_e

h [N, H], w [N, E] fp32 (zero outside each row's top k), the layer's
experts_gate / experts_up [E, H, F] and experts_down [E, F, H]; out [N, H]
fp32.  It replaces no TPU kernel (the JAX package has no mixture of experts).
On a CUDA tensor it launches `csrc/moe_experts.cu` once per group of up to
16 rows (design and bound are described there: only the experts some row of
the group was routed to are read, found on the device, so a captured step
reads nothing of the routing on the host); `plan` sizes a launch and
`schedule` mirrors how its CTAs share the units.  On a CPU tensor it runs
`moe_experts_ref`, the plain version with the same signature (every expert
as batched matmuls, weighed by the zero gate), which is also the kernel's
oracle.  The kernel keeps every product's sum and y in fp32 and rounds a to
bf16 once, where the tensor cores take it; the plain version rounds g, u, a
and y to the weights' dtype.  The workspace is cached per device, stream and
shape (`workspace`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

TILE = 64          # columns of a weight box, and of a unit (TC in the source)
DOWN_ROWS = 32     # rows of down in a ring chunk (KR in the source)
ROW_GROUP = 16     # rows a launch takes, at most
MAX_EXPERTS = 256  # experts a layer, at most (MAX_E in the source)
_WARPS = 8         # consumer warps (the producer is a ninth)
_SMEM_MAX = 227 * 1024
_MAX_STAGES = 8


def moe_experts_ref(h: torch.Tensor, w: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                    down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: every expert on every row of h [N, H], weighed by w
    [N, E] (fp32 sum) -> [N, H] fp32."""
    e = w.shape[1]
    x = h[None].expand(e, -1, -1)
    a = F.silu(torch.bmm(x, gate)) * torch.bmm(x, up)
    y = torch.bmm(a, down)                                               # [E, N, H]
    return torch.einsum("enh,ne->nh", y.float(), w)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def moe_smem(h: int, e: int, rg: int, ku: int, stages: int, umax: int) -> int:
    """Shared memory of one CTA (`layout` in csrc/moe_experts.cu): the ring,
    h [rg][Hp + 8] bf16 (Hp: h padded to whole chunks), the units' a [umax][rg]
    [72] bf16, the list of hit experts with its length and the warps' counts,
    the mbarriers, and 1024 bytes to align the base."""
    stage_bytes = max(2 * ku * TILE * 2, DOWN_ROWS * _WARPS * TILE * 2)
    return (stages * stage_bytes + rg * (_cdiv(h, ku) * ku + 8) * 2
            + umax * rg * (TILE + 8) * 2 + _cdiv(4 * (e + 1 + _WARPS), 16) * 16
            + 16 * stages + 1024)


class MoePlan(NamedTuple):
    rg: int           # rows of the mma tile the launch fills: 8 or 16
    ku: int           # gate/up rows per ring chunk
    stages: int       # ring stages
    stage_bytes: int  # bytes per stage
    umax: int         # units a CTA takes, at most (every expert hit)
    smem: int         # shared memory per CTA, bytes
    ctas: int         # CTAs launched: one an SM, all resident


def plan(n: int, h: int, f: int, e: int, ctas: int) -> MoePlan:
    """The launch for n <= 16 rows of width h, expert width f and e experts
    on a card that holds `ctas` CTAs of the kernel at once (one an SM): rows
    in one mma tile of 8 (n <= 8) or 16; gate/up chunks of 128 rows (64 where
    h is not a multiple of 128), which fill a stage of 32 KB as a chunk of
    down (32 rows by 512 columns) does; room for the a of the most units a
    CTA can take (all e experts hit); then as many stages as the shared
    memory left holds (at most 8)."""
    if not 1 <= n <= ROW_GROUP:
        raise ValueError(f"a launch of the expert kernel takes 1 to {ROW_GROUP} rows, got {n}")
    if h < TILE or h % TILE or f < 8 or f % 8 or not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"the expert kernel takes H a multiple of {TILE}, F a multiple of 8 "
                         f"and 1 to {MAX_EXPERTS} experts; got H={h}, F={f}, E={e}")
    if ctas < 1:
        raise ValueError("no CTA of the expert kernel fits the card")
    rg = 8 if n <= 8 else 16
    ku = 128 if h % 128 == 0 else 64
    umax = _cdiv(e * _cdiv(f, TILE), ctas)
    stage_bytes = max(2 * ku * TILE * 2, DOWN_ROWS * _WARPS * TILE * 2)
    rest = moe_smem(h, e, rg, ku, 0, umax)
    stages = min(_MAX_STAGES, (_SMEM_MAX - rest) // (stage_bytes + 16))
    if stages < 2:
        raise ValueError(f"the expert kernel does not fit shared memory at H={h}, F={f}, "
                         f"{e} experts, {rg} rows on {ctas} CTAs")
    return MoePlan(rg, ku, stages, stage_bytes, umax, moe_smem(h, e, rg, ku, stages, umax),
                   ctas)


def row_groups(n: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each launch of an n-row call: groups of 16."""
    return [(n0, min(ROW_GROUP, n - n0)) for n0 in range(0, n, ROW_GROUP)]


def schedule(k: int, f: int, ctas: int) -> List[List[Tuple[int, int]]]:
    """How a launch's CTAs share the work when its rows hit k experts (the
    kernel's `unit`): per CTA, its units (i, j), hit expert i's F columns
    [64j, 64j + 64) and the same rows of its down, in the order it takes
    them: CTA c the units c, c + ctas, ... of the k * ceil(f / 64),
    expert-major."""
    nft = _cdiv(f, TILE)
    return [[(u // nft, u % nft) for u in range(c, k * nft, ctas)] for c in range(ctas)]


_PLANS: Dict[tuple, MoePlan] = {}


def plan_for(device: torch.device, n: int, h: int, f: int, e: int) -> MoePlan:
    """`plan` for a launch of n rows on `device`, made once per device and
    shape, for the CTAs the card holds at once at the plan's shared memory
    (one an SM)."""
    key = (str(device), 8 if n <= 8 else 16, h, f, e)
    p = _PLANS.get(key)
    if p is None:
        lib = _library()
        sms = cuda_build.sm_count(device)
        p = plan(n, h, f, e, sms)
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.vv_moe_experts_ctas(p.smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"vv_moe_experts_ctas failed with code {rc}")
        if out.value < 1:
            raise RuntimeError(f"no CTA of the expert kernel ({p.smem} bytes of shared memory) "
                               f"fits {device}")
        _PLANS[key] = p
    return p


_WORKSPACE = {}


def workspace(device, stream: int, ctas: int, h: int):
    """The kernel's workspace, made once per device, stream and shape: each
    CTA's share of the output, part [ctas, 16, H] fp32, and the grid
    barrier's int32 counter (0 at first; every launch leaves its low bits
    0).  Calls on one stream run in order, so they share it safely."""
    key = (str(device), stream, ctas, h)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty(ctas * ROW_GROUP * h, dtype=torch.float32, device=device),
              torch.zeros(4, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def _check(h, w, gate, up, down):
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[0]:
        raise ValueError(f"h must be [N, H] and w [N, E], got {tuple(h.shape)} and "
                         f"{tuple(w.shape)}")
    n, hd = h.shape
    e = w.shape[1]
    if gate.dim() != 3:
        raise ValueError(f"experts_gate must be [E, H, F], got {tuple(gate.shape)}")
    f = gate.shape[2]
    for name, t, shape in (("experts_gate", gate, (e, hd, f)), ("experts_up", up, (e, hd, f)),
                           ("experts_down", down, (e, f, hd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if hd % TILE or f % 8 or e > MAX_EXPERTS:
        raise ValueError(f"the expert kernel takes H a multiple of {TILE}, F a multiple of 8 "
                         f"and at most {MAX_EXPERTS} experts; got H={hd}, F={f}, E={e}")
    for t in (h, gate, up, down):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the expert kernel takes bfloat16 rows and experts, one is {t.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"the expert kernel takes fp32 gate weights, got {w.dtype}")
    for name, t in (("h", h), ("w", w), ("experts_gate", gate), ("experts_up", up),
                    ("experts_down", down)):
        if t.device != h.device:
            raise ValueError(f"all operands must be on {h.device}, {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the expert kernel reads contiguous operands; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte unit (the kernel's tensor maps "
                             f"and vector loads)")


def moe_experts(h: torch.Tensor, w: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighed sum of h [N, H] -> [N, H] fp32.  CUDA
    tensors launch the kernel (one launch per 16 rows, each counted); CPU
    tensors take `moe_experts_ref`."""
    if h.device.type == "cpu":
        return moe_experts_ref(h, w, gate, up, down)
    if h.device.type != "cuda":
        raise ValueError(f"moe_experts runs on cuda or cpu, not {h.device}")
    _check(h, w, gate, up, down)
    n, hd = h.shape
    e, f = w.shape[1], gate.shape[2]
    out = torch.empty((n, hd), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    lib = _library()
    for n0, nr in row_groups(n):
        p = plan_for(h.device, nr, hd, f, e)
        part, bar = workspace(h.device, stream, p.ctas, hd)
        with torch.cuda.device(h.device):
            rc = lib.vv_moe_experts(
                h.data_ptr() + 2 * n0 * hd, w.data_ptr() + 4 * n0 * e, gate.data_ptr(),
                up.data_ptr(), down.data_ptr(), out.data_ptr() + 4 * n0 * hd, part.data_ptr(),
                bar.data_ptr(), nr, hd, f, e, p.rg, p.ku, p.stages, p.umax, p.ctas, stream)
        if rc != 0:
            raise RuntimeError(f"moe_experts kernel failed with code {rc}")
        moe_experts.launches += 1
    return out


moe_experts.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("moe_experts")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.vv_moe_experts, [p] * 8 + [i] * 9 + [p]),
                     (lib.vv_moe_experts_ctas, [ctypes.c_longlong, ctypes.POINTER(i)])):
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def hit_bytes(w: torch.Tensor, h: int, f: int, elem: int = 2) -> int:
    """Bytes a call must move: each row group's hit experts' gate, up and
    down once, h and the output once, w once."""
    n, e = w.shape
    hit = sum(int((w[n0:n0 + nr] != 0).any(dim=0).sum()) for n0, nr in row_groups(n))
    return hit * 3 * h * f * elem + n * h * (elem + 4) + n * e * 4


__all__ = ["moe_experts", "moe_experts_ref", "plan", "plan_for", "schedule", "row_groups",
           "moe_smem", "MoePlan", "workspace", "hit_bytes", "TILE", "DOWN_ROWS", "ROW_GROUP",
           "MAX_EXPERTS"]
