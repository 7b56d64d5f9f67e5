"""Causal GQA flash attention, dense and paged: the CUDA kernels'
wrappers and their plain versions (port of
repro/kernels/flash_attention.py::flash_attention_bhsd and
::paged_flash_attention, the TPU kernels, and repro/kernels/ref.py::
flash_attention_ref and ::paged_attention_ref, their oracles).

`flash_attention_bhsd` launches `csrc/flash_attention.cu` (bf16 on the
tensor cores, fp32 on CUDA cores) and `paged_flash_attention` launches
`csrc/paged_attention.cu` (a decode step, C = 1, as a split-over-keys
kernel and a combine kernel; chunks, C > 1, as one kernel: bf16 on the
tensor cores, fp32 on CUDA cores) for CUDA tensors; each takes its plain
version only for CPU tensors and their meta branch (kernels/meta.py)
only for meta tensors.  The kernel sources note what bounds them on the
card and how their design answers that.  Each wrapper's
`.launches` counts its calls that launched; `paged_flash_attention.
chunk_launches` counts those with C > 1 apart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta as META

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# logical keys per split of a paged decode call (KS in paged_attention.cu)
DECODE_KEYS_PER_SPLIT = 64
# a bf16 chunk call's tiles (CQ, CK and CMAX_SPLITS in paged_attention.cu):
# packed query rows per block (4 warps x 16), logical keys per K/V tile,
# and the most blocks (a cluster) that split one query tile's key tiles
CHUNK_QUERY_ROWS = 64
CHUNK_KEYS_PER_TILE = 64
CHUNK_MAX_SPLITS = 8
# the dense kernel's query and key tile (TQ = TK in flash_attention.cu's
# tensor-core kernel, BQ = BK in its fp32 CUDA-core kernel)
FLASH_TILE = {torch.bfloat16: 64, torch.float32: 32}


def flash_flops(bh: int, s: int, d: int, dtype) -> float:
    """The dense kernel's product work: every causal (query tile, key
    tile) pair it visits, QK^T and PV over whole tiles, 2 a multiply-add."""
    t = FLASH_TILE[dtype]
    n = -(-s // t)
    return 4.0 * bh * (n * (n + 1) // 2) * t * t * d


def flash_attention_plain(q, k, v, *, sm_scale=None):
    """q (BH,S,D), k/v (BHkv,S,D) heads-major GQA packing; causal."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    g = bh // k.shape[0]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
    s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def check_args(q, k, v) -> int:
    """Validate what the kernel takes; returns the GQA group size."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q (BH,S,D), k/v (BHkv,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 q/k/v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    bh, s, d = q.shape
    if k.shape[1] != s or k.shape[2] != d:
        raise ValueError(f"q and k/v differ in S or D: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} (the model only needs Sq == Sk)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"BH={bh} is not a multiple of BHkv={k.shape[0]}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the grid's y limit")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")
    return bh // k.shape[0]


def check_aligned(*tensors, strides=()) -> None:
    """The kernels read 16 bytes a lane: raise unless each tensor's data
    and each given element stride start on a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"tensor data at {t.data_ptr():#x} is not "
                             "16-byte aligned")
    for t, stride in strides:
        if stride * t.element_size() % 16:
            raise ValueError(f"stride {stride} x {t.element_size()} bytes "
                             "is not a multiple of 16 bytes")


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_bhsd(q, k, v, *, sm_scale=None):
    """Causal flash attention; q row b reads kv row b // group.  Output in
    q's dtype.

    Where autograd records and q, k or v requires grad, the launch goes
    through `_FlashAttention`: the forward is still the kernel (and
    counts), the backward the VJP of the plain version recomputed from
    the saved inputs (the reference differentiates XLA's attention: it
    has no backward kernel either)."""
    group = check_args(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash kernel for device {q.device}")
    scale = float(sm_scale if sm_scale is not None else q.shape[2] ** -0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _flash_launch(q, k, v, group, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _flash_launch(q, k, v, q.shape[0] // k.shape[0], scale)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_plain(*qkv, sm_scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        return dq, dk, dv, None


def _flash_launch(q, k, v, group: int, scale: float):
    bh, s, d = q.shape
    if q.is_meta:
        return META.launch("flash_attention_bhsd", torch.empty_like(q),
                           flops=flash_flops(bh, s, d, q.dtype),
                           nbytes=META.nbytes(q, k, v, q))
    lib = _lib()
    if q.dtype == torch.bfloat16:
        check_aligned(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            group, s, d, scale, int(q.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "flash_attention_fwd")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0


# ---------------------------------------------------------------------------
# Paged attention: K/V read through a page table from shared page pools
# ---------------------------------------------------------------------------

def paged_flash_attention_plain(q, k_pool, v_pool, page_table, pos, *,
                                sm_scale=None):
    """Transcription of the oracle (ref.paged_attention_ref).

    q (B, C, Hq, D) at absolute positions pos[b]..pos[b]+C-1; k_pool /
    v_pool (P+1, ps, Hkv, D), page P the trash page; page_table (B, n)
    int, -1 = unallocated.  Gathers the table's pages into a contiguous
    (B, n*ps) view and runs masked softmax attention in fp32: causally
    invisible and unallocated positions contribute exactly 0, and a
    fully masked row gives 0."""
    b, c, hq, d = q.shape
    pn1, ps, hkv, _ = k_pool.shape
    n = page_table.shape[1]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    table = page_table.long()
    pt = torch.where(table < 0, torch.full_like(table, pn1 - 1), table)
    kg = k_pool[pt.reshape(-1)].reshape(b, n * ps, hkv, d)
    vg = v_pool[pt.reshape(-1)].reshape(b, n * ps, hkv, d)
    kg = kg.repeat_interleave(g, dim=2)
    vg = vg.repeat_interleave(g, dim=2)
    s = torch.einsum("bchd,bkhd->bhck", q.float(), kg.float()) * scale
    qpos = pos.long()[:, None] + torch.arange(c, device=q.device)[None]
    kvpos = torch.arange(n * ps, device=q.device)[None]
    valid = ((kvpos[:, None, :] <= qpos[:, :, None])
             & (table.repeat_interleave(ps, dim=1) >= 0)[:, None, :])
    valid = valid[:, None]                                  # (B,1,C,n*ps)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-5e29)
    p = torch.exp(s - m)
    p = torch.where(valid, p, torch.zeros_like(p))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-20)
    o = torch.einsum("bhck,bkhd->bchd", p, vg.float())
    return o.to(q.dtype)


def check_paged_args(q, k_pool, v_pool, page_table, pos) -> None:
    """Validate what the paged kernel takes (shard-stacked or not)."""
    if q.dim() not in (4, 5) or k_pool.dim() != q.dim() \
            or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"want q ([tp,] B, C, Hq, D) and pools ([tp,] P+1, ps, Hkv, D); "
            f"got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 q/pools of one dtype; "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if q.dim() == 5 and q.shape[0] != k_pool.shape[0]:
        raise ValueError(f"q has {q.shape[0]} shards, pools "
                         f"{k_pool.shape[0]}")
    b, c, hq, d = q.shape[-4:]
    pn1, ps, hkv, dk = k_pool.shape[-4:]
    if dk != d or d not in HEAD_DIMS:
        raise ValueError(f"head dims q {d}, pools {dk}; want equal and in "
                         f"{HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] == 0 or page_table.is_floating_point():
        raise ValueError(f"want an integer page table (B={b}, n>0); got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if tuple(pos.shape) != (b,) or pos.is_floating_point():
        raise ValueError(f"want integer pos ({b},); got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    inner = (ps * hkv * d, hkv * d, d, 1)
    if tuple(k_pool.stride()[-4:]) != inner \
            or v_pool.stride() != k_pool.stride():
        raise ValueError(
            "each shard's pool block (P+1, ps, Hkv, D) must be contiguous, "
            "with k and v pools of equal strides; got strides "
            f"{k_pool.stride()}, {v_pool.stride()}")
    if not (q.device == k_pool.device == v_pool.device):
        raise ValueError("q and the pools on different devices")
    rows = b * (q.shape[0] if q.dim() == 5 else 1)
    if rows > 65535 or hkv > 65535:
        raise ValueError(f"grid too large: rows {rows}, kv heads {hkv}")
    if pn1 < 1 or ps < 1 or c < 1:
        raise ValueError(f"empty pools or chunk: {tuple(k_pool.shape)}, "
                         f"C={c}")


def plan_decode_splits(n: int, ps: int, *, rows: int, hkv: int, g: int,
                       d: int, ks: int = DECODE_KEYS_PER_SPLIT) -> tuple:
    """How a decode call (C = 1) splits its keys: n_splits blocks of `ks`
    logical keys over a table of n pages of ps, and the fp32 scratch of
    partials, (rows, hkv, n_splits, g, d + 2): acc[:d], m at d, l at d + 1.
    From shapes alone, so planning never waits on the card."""
    n_splits = -(-n * ps // ks)
    return n_splits, (rows, hkv, n_splits, g, d + 2)


def _paged_lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        dec = lib.paged_decode_fwd
        dec.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        dec.restype = ctypes.c_int
    return lib


def paged_flash_attention(q, k_pool, v_pool, page_table, pos, *,
                          sm_scale=None):
    """Paged causal flash attention reading K/V through a page table.

    The reference's shapes: q (B, C, Hq, D), pools (P+1, ps, Hkv, D),
    table (B, n) int (-1 = unallocated), pos (B,).  Or shard-stacked:
    q (tp, B, C, Hq, D) and pools (tp, P+1, ps, Hkv, D), one table and
    pos for every shard; the pools may be a strided view (a layer of a
    segment leaf) as long as each shard's (P+1, ps, Hkv, D) block is
    contiguous: nothing is copied.  Output in q's dtype.

    On the card a decode step (C = 1) runs as two launches, the keys split
    over blocks of DECODE_KEYS_PER_SPLIT and their partials combined
    (`plan_decode_splits`); a chunk (C > 1) as one, in bf16 on the tensor
    cores (blocks of CHUNK_QUERY_ROWS packed query rows, K/V tiles of
    CHUNK_KEYS_PER_TILE keys gathered through the table, split over a
    cluster of up to CHUNK_MAX_SPLITS blocks that merge their partials;
    the kernel plans the split from the table's width).
    `.launches` counts calls either way, `.chunk_launches` the chunks."""
    check_paged_args(q, k_pool, v_pool, page_table, pos)
    if q.device.type == "cpu":
        if q.dim() == 4:
            return paged_flash_attention_plain(
                q, k_pool, v_pool, page_table, pos, sm_scale=sm_scale)
        return torch.stack([paged_flash_attention_plain(
            q[t], k_pool[t], v_pool[t], page_table, pos, sm_scale=sm_scale)
            for t in range(q.shape[0])])
    if q.device.type == "meta":
        return _paged_meta(q, k_pool, page_table)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for device {q.device}")
    build.refuse_grad("paged_flash_attention", q, k_pool, v_pool)
    qf = q if q.dim() == 5 else q[None]
    kf = k_pool if k_pool.dim() == 5 else k_pool[None]
    vf = v_pool if v_pool.dim() == 5 else v_pool[None]
    tp, b, c, hq, d = qf.shape
    _, pn1, ps, hkv, _ = kf.shape
    n = page_table.shape[1]
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    lib = _paged_lib()
    out = torch.empty_like(qf)
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    start = pos.to(device=q.device, dtype=torch.int32).contiguous()
    is_bf16 = int(q.dtype == torch.bfloat16)
    check_aligned(qf, kf, vf, strides=((kf, kf.stride(0)),))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if c == 1:
            n_splits, shape = plan_decode_splits(
                n, ps, rows=tp * b, hkv=hkv, g=hq // hkv, d=d)
            part = torch.empty(shape, dtype=torch.float32, device=q.device)
            what = "paged_decode_fwd"
            rc = lib.paged_decode_fwd(
                qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                table.data_ptr(), start.data_ptr(), part.data_ptr(),
                out.data_ptr(), tp, b, hq, hkv, d, ps, n, n_splits,
                kf.stride(0), scale, is_bf16, stream)
        else:
            what = "paged_attention_fwd"
            rc = lib.paged_attention_fwd(
                qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), table.data_ptr(),
                start.data_ptr(), out.data_ptr(), tp, b, c, hq, hkv, d, ps,
                n, kf.stride(0), scale, is_bf16, stream)
    build.check(lib, rc, what)
    paged_flash_attention.launches += 1
    if c > 1:
        paged_flash_attention.chunk_launches += 1
    return out if q.dim() == 5 else out[0]


paged_flash_attention.launches = 0
paged_flash_attention.chunk_launches = 0


def _paged_meta(q, k_pool, page_table):
    """The paged kernel's meta branch.  Its work depends on the positions,
    which a meta tensor does not hold: it counts every key of the table's
    width for every query (the most a call can read), QK^T and PV, and
    the K/V bytes of those pages."""
    b, c, hq, d = q.shape[-4:]
    hkv = k_pool.shape[-2]
    keys = page_table.shape[1] * k_pool.shape[-3]
    shards = q.shape[0] if q.dim() == 5 else 1
    kv = 2 * shards * b * keys * hkv * d * k_pool.element_size()
    return META.launch("paged_flash_attention", torch.empty_like(q),
                       flops=4.0 * shards * b * c * hq * keys * d,
                       nbytes=2 * META.nbytes(q) + kv)
