"""PyTorch port: the dry run's pieces (launch/dryrun.py, launch/count.py,
kernels/meta.py) against the reference's (repro/launch/dryrun.py).

The new config classes field for field; `cell_applicable` and
`spd_plan_for` on every assigned arch x shape x spd x comm; the
parameter and input structs of every assigned arch at tp 16 against the
reference's `jax.eval_shape` structs (the port's shard axis merged
back); each kernel's meta branch against its plain version's shapes and
dtypes and its recorded formula; and, at reduced size on the CPU, the
meta count of a cell against the same step run on real tensors (the
ledger bit for bit), which chip_smoke.py repeats at full size on the
card.  The records against the reference's CLI are in
tests/test_torch_dryrun_cells.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.config import base as RB
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_config
from repro.launch import dryrun as RD
from repro_torch.config import base as PB
from repro_torch.config.base import SMOKE_SHAPES, replace
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core import simtp
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import meta as META
from repro_torch.kernels import quant_collectives as QC
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch import dryrun as D
from repro_torch.launch.count import MetaCount
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel.collectives import collective_ledger
from repro_torch.tree import tree_leaves
from torch_parity import one_torch_thread  # noqa: F401

TP = 16


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_shape_and_mesh_configs_equal_the_references():
    for name in ("SHAPES", "SMOKE_SHAPES"):
        ref, port = getattr(RB, name), getattr(PB, name)
        assert list(ref) == list(port)
        for k in ref:
            assert _fields(ref[k]) == _fields(port[k])
            assert ref[k].tokens == port[k].tokens
    for name in ("SINGLE_POD", "MULTI_POD"):
        ref, port = getattr(RB, name), getattr(PB, name)
        assert _fields(ref) == _fields(port)
        assert ((ref.n_devices, ref.tp, ref.dp)
                == (port.n_devices, port.tp, port.dp))
    odd = (PB.MeshConfig((3, 5), ("data", "x")),
           RB.MeshConfig((3, 5), ("data", "x")))
    assert ((odd[0].n_devices, odd[0].tp, odd[0].dp)
            == (odd[1].n_devices, odd[1].tp, odd[1].dp) == (15, 1, 3))
    assert ASSIGNED == REF_ASSIGNED


def _plan_fields(plan):
    comm = plan.comm
    return (tuple(plan.drop_mask), None if comm is None else
            (tuple(comm.block_modes), comm.logits_mode))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_applicability_and_plans_equal_the_references(arch):
    for shape in PB.SHAPES:
        assert D.cell_applicable(arch, shape) == RD.cell_applicable(arch,
                                                                     shape)
    for spd in (0.0, 0.7):
        for comm in ("exact", "quant8"):
            for logits in ("exact", "quant8"):
                assert _plan_fields(D.spd_plan_for(
                    get_config(arch), spd, comm, logits)) == _plan_fields(
                    RD.spd_plan_for(ref_config(arch), spd, comm, logits))


def _shape_dtype(a):
    return tuple(a.shape), str(a.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_input_structs_equal_the_references(arch):
    """The reference's structs are jax.eval_shape's: nothing is drawn on
    either side.  The port's leaves carry a leading (tp, ...) shard axis,
    merged back here (simtp.merge_stacked) before comparing."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    plan, rplan = D.spd_plan_for(cfg, 0.7), RD.spd_plan_for(rcfg, 0.7)
    port = D.param_structs(cfg, plan, TP)
    assert all(t.is_meta and t.shape[0] == TP for t in tree_leaves(port))
    merged = simtp.merge_stacked(port, cfg, plan, TP)
    ref = jax.tree_util.tree_leaves_with_path(
        RD.param_structs(rcfg, rplan, TP))
    mine = tree_leaves(merged)
    assert len(ref) == len(mine)
    for (path, r), p in zip(ref, mine):
        assert _shape_dtype(r) == _shape_dtype(p), jax.tree_util.keystr(path)
    for name, shape in PB.SHAPES.items():
        if not D.cell_applicable(arch, name):
            continue
        r_in = RD.input_structs(rcfg, RB.SHAPES[name], rplan, TP)
        p_in = D.input_structs(cfg, shape, plan, TP)
        assert sorted(r_in) == sorted(p_in)
        for k in r_in:
            r_l = jax.tree_util.tree_leaves(r_in[k])
            p_l = tree_leaves(p_in[k])
            assert [_shape_dtype(a) for a in r_l] == [
                _shape_dtype(a) for a in p_l], (name, k)


def test_meta_init_draws_nothing_and_weight_int8_works_on_meta():
    cfg = replace(get_config("llama2-7b"), weight_dtype="int8")
    plan = D.spd_plan_for(cfg, 0.7)
    p = D.param_structs(cfg, plan, TP)
    leaves = tree_leaves(p)
    assert all(t.is_meta for t in leaves)
    assert torch.int8 in {t.dtype for t in leaves}


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------

def _meta(*ts):
    return [t.to("meta") for t in ts]


def _same(plain, meta_out):
    p, m = tree_leaves(plain), tree_leaves(meta_out)
    assert [(tuple(a.shape), a.dtype) for a in p] == [
        (tuple(b.shape), b.dtype) for b in m]
    assert all(b.is_meta for b in m)


def _one(work, name):
    assert list(work) == [name]
    assert work[name]["calls"] == 1
    return work[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branch_records_the_causal_tiles(dtype):
    g = torch.Generator().manual_seed(0)
    bh, s, d = 6, 520, 32
    q = torch.randn(bh, s, d, generator=g).to(dtype)
    k = torch.randn(bh // 3, s, d, generator=g).to(dtype)
    v = torch.randn(bh // 3, s, d, generator=g).to(dtype)
    plain = FA.flash_attention_plain(q, k, v)
    with META.kernel_work() as work:
        out = FA.flash_attention_bhsd(*_meta(q, k, v))
    _same(plain, out)
    w = _one(work, "flash_attention_bhsd")
    t = FA.FLASH_TILE[dtype]
    n = -(-s // t)
    # every (query tile, key tile <= it) pair, whole tiles, QK^T and PV
    tiles = sum(i + 1 for i in range(n))
    assert w["flops"] == 4.0 * bh * tiles * t * t * d
    assert w["flops"] < 4.0 * bh * s * s * d          # not the full S x S
    # q, k, v read once, the output written once
    assert w["nbytes"] == (2 * q.numel() + 2 * k.numel()) * q.element_size()
    assert FA.flash_attention_bhsd.launches == 0


def test_flash_meta_branch_under_autograd_backs_through_the_plain_vjp():
    q, k, v = (torch.empty(4, 64, 16, device="meta", requires_grad=True)
               for _ in range(3))
    with META.kernel_work() as work, MetaCount() as mc:
        out = FA.flash_attention_bhsd(q, k, v)
        out.sum().backward()
    assert work["flash_attention_bhsd"]["calls"] == 1
    assert q.grad is not None and q.grad.shape == q.shape
    assert mc.aten_flops > 0                       # the plain VJP's products


def test_paged_meta_branch_counts_the_tables_keys():
    g = torch.Generator().manual_seed(1)
    b, c, hq, hkv, d, ps, pages, n = 2, 3, 4, 2, 16, 8, 6, 3
    q = torch.randn(b, c, hq, d, generator=g)
    kp = torch.randn(pages + 1, ps, hkv, d, generator=g)
    vp = torch.randn(pages + 1, ps, hkv, d, generator=g)
    table = torch.tensor([[0, 1, -1], [2, 3, 4]])
    pos = torch.tensor([5, 17])
    plain = FA.paged_flash_attention(q, kp, vp, table, pos)
    with META.kernel_work() as work:
        out = FA.paged_flash_attention(*_meta(q, kp, vp, table, pos))
    _same(plain, out)
    w = _one(work, "paged_flash_attention")
    assert w["flops"] == 4.0 * b * c * hq * n * ps * d
    assert w["nbytes"] == (2 * q.numel() * 4
                           + 2 * b * n * ps * hkv * d * 4)


def test_fused_norm_meta_branch():
    g = torch.Generator().manual_seed(2)
    x, r = torch.randn(5, 48, generator=g), torch.randn(5, 48, generator=g)
    w = torch.randn(48, generator=g)
    plain = FN.fused_residual_rmsnorm_plain(x, r, w)
    with META.kernel_work() as work:
        out = FN.fused_residual_rmsnorm(*_meta(x, r, w))
    _same(plain, out)
    rec = _one(work, "fused_residual_rmsnorm")
    assert rec["flops"] == 0
    assert rec["nbytes"] == (4 * x.numel() + w.numel()) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_branch_records_its_chunks(dtype):
    g = torch.Generator().manual_seed(3)
    bt, s, h, p, gr, n, chunk = 2, 40, 4, 16, 2, 16, 16
    x = torch.randn(bt, s, h, p, generator=g).to(dtype)
    dt = torch.rand(bt, s, h, generator=g)
    a = -torch.rand(bt, h, generator=g)
    bm = torch.randn(bt, s, gr, n, generator=g).to(dtype)
    cm = torch.randn(bt, s, gr, n, generator=g).to(dtype)
    dd = torch.randn(bt, h, generator=g)
    plain = SS.ssd_scan_plain(x, dt, a, bm, cm, dd, chunk=chunk)
    with META.kernel_work() as work:
        out = SS.ssd_scan(*_meta(x, dt, a, bm, cm, dd), chunk=chunk)
    _same(plain, out)
    w = _one(work, "ssd_scan")
    nc = -(-s // chunk)
    assert w["flops"] == 2.0 * bt * nc * (gr * chunk * chunk * n + h * (
        chunk * chunk * p + 2 * chunk * p * n))
    assert SS.ssd_scan.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_flops_are_the_plain_count_over_the_causal_tiles(dtype):
    """An independent count: aten's flop counter over the plain version
    (the full S x S) at a tile-aligned S, times the share of tiles that
    the kernel visits, (n + 1) / 2n of n x n."""
    t = FA.FLASH_TILE[dtype]
    bh, n, d = 4, 3, 16
    q = torch.randn(bh, n * t, d).to(dtype)
    k = torch.randn(bh // 2, n * t, d).to(dtype)
    with FlopCounterMode(display=False) as fc:
        FA.flash_attention_plain(q, k, k)
    with META.kernel_work() as work:
        FA.flash_attention_bhsd(*_meta(q, k, k))
    assert work["flash_attention_bhsd"]["flops"] == (
        fc.get_total_flops() * (n + 1) / (2 * n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_flops_are_the_plain_count_less_the_shared_scores(dtype):
    """An independent count: aten's flop counter over the plain scan at
    whole chunks, which forms C.B^T once a head where the kernel forms
    it once a group of heads."""
    g = torch.Generator().manual_seed(5)
    bt, nc, h, p, gr, n, chunk = 2, 3, 4, 16, 2, 16, 16
    s = nc * chunk
    x = torch.randn(bt, s, h, p, generator=g).to(dtype)
    dt = torch.rand(bt, s, h, generator=g)
    a = -torch.rand(bt, h, generator=g)
    bm = torch.randn(bt, s, gr, n, generator=g).to(dtype)
    cm = torch.randn(bt, s, gr, n, generator=g).to(dtype)
    dd = torch.randn(bt, h, generator=g)
    with FlopCounterMode(display=False) as fc:
        SS.ssd_scan_plain(x, dt, a, bm, cm, dd, chunk=chunk)
    with META.kernel_work() as work:
        SS.ssd_scan(*_meta(x, dt, a, bm, cm, dd), chunk=chunk)
    shared = 2.0 * bt * nc * (h - gr) * chunk * chunk * n
    assert work["ssd_scan"]["flops"] == fc.get_total_flops() - shared


def _quant_cases():
    x = torch.randn(3, 300, generator=torch.Generator().manual_seed(4))
    q, s = QC.quantize_absmax_plain(x, levels=127)
    msg = QC.quantize_message_absmax_plain(x, levels=127)
    return [
        ("qdq_absmax", QC.qdq_absmax_plain, QC.qdq_absmax, (x,),
         dict(levels=127), 2 * x.numel() * 4),
        ("quantized_psum_absmax", QC.quantized_psum_absmax_plain,
         QC.quantized_psum_absmax, (x,), dict(levels=7), 2 * x.numel() * 4),
        ("quantize_absmax", QC.quantize_absmax_plain, QC.quantize_absmax,
         (x,), dict(levels=127), x.numel() * 5 + s.numel() * 4),
        ("dequantize_absmax", QC.dequantize_absmax_plain,
         QC.dequantize_absmax, (q, s), {}, q.numel() * 5 + s.numel() * 4),
        ("dequant_accum_absmax", QC.dequant_accum_absmax_plain,
         QC.dequant_accum_absmax, (q, s, x), {},
         q.numel() * 9 + s.numel() * 4),
        ("quantize_message_absmax", QC.quantize_message_absmax_plain,
         QC.quantize_message_absmax, (x,), dict(levels=127),
         x.numel() * 4 + msg.numel()),
        ("reduce_messages_absmax", QC.reduce_messages_absmax_plain,
         QC.reduce_messages_absmax, (msg, 300),
         dict(levels=127, dtype=torch.float32), msg.numel() + 300 * 4),
    ]


@pytest.mark.parametrize("case", _quant_cases(), ids=lambda c: c[0])
def test_quant_meta_branches(case):
    name, plain_fn, fn, args, kw, nbytes = case
    plain = plain_fn(*args, **kw)
    margs = [a.to("meta") if isinstance(a, torch.Tensor) else a
             for a in args]
    with META.kernel_work() as work:
        out = fn(*margs, **kw)
    _same(plain, out)
    w = _one(work, name)
    assert (w["flops"], w["nbytes"]) == (0, nbytes)
    assert getattr(fn, "launches") == 0


def test_the_card_check_still_refuses_what_is_not_cpu_or_cuda():
    """cpu takes the plain version, meta the meta branch (before this
    check), cuda the kernel; the check raises for any other device."""
    x = torch.empty(2, 256, device="meta")
    with pytest.raises(ValueError, match="kernel for device meta"):
        QC._on_card(x, "qdq")
    assert QC._on_card(torch.empty(2, 256), "qdq") is False


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def test_meta_count_flops_peak_and_reads():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    unused = torch.empty(1000, device="meta")
    with MetaCount() as mc:
        c = a @ b                                   # 64*16 new floats
        d = torch.relu(c)                           # another
        del c
        e = d.view(-1)                              # a view: no storage
        _ = unused[:10]                             # a view reads nothing
        del d, e
    assert mc.aten_flops == 2 * 64 * 32 * 16
    assert mc.peak_bytes == 2 * 64 * 16 * 4
    assert mc.reads(a) and mc.reads(b) and not mc.reads(unused)


# ---------------------------------------------------------------------------
# The count against a real run (reduced size, CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m-reduced", "hymba-1.5b-reduced",
                                  "qwen2-moe-a2.7b-reduced",
                                  "deepseek-v2-lite-16b-reduced",
                                  "musicgen-medium-reduced"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "long_500k"])
def test_meta_count_ledger_equals_a_real_run(arch, shape):
    """The serving step of a cell at SMOKE_SHAPES on a (2 data, 4 model)
    mesh, once on meta (count_cell) and once on real CPU tensors
    (serve_step): the ledgers agree key for key, bit for bit; the real
    outputs are finite and have the meta outputs' shapes."""
    cfg = replace(get_config(arch), attn_backend="pallas")
    mesh, sc = make_test_mesh(2, 4), SMOKE_SHAPES[shape]
    plan = D.spd_plan_for(cfg, 0.7)
    rec = D.count_cell(cfg, sc, mesh, plan)
    meta = D.serve_step(cfg, sc, mesh, plan)
    with torch.no_grad():
        meta_out = meta["step"](*meta["args"])
    cell = D.serve_step(cfg, sc, mesh, plan, device="cpu", seed=0)
    with collective_ledger() as led, torch.no_grad():
        out = cell["step"](*cell["args"])
    got = D.ledger_bytes(led)
    assert got == rec["ledger_bytes_per_device"] and got
    assert [tuple(t.shape) for t in tree_leaves(out)] == [
        tuple(t.shape) for t in tree_leaves(meta_out)]
    assert bool(torch.isfinite(out[0].float()).all())
    assert rec["count"]["rows"] == (1 if sc.global_batch < 2 else
                                    sc.global_batch // 2)
    assert sum(rec["collective_op_counts"].values()) >= len(led)
    assert np.isfinite(rec["flops_total"]) and rec["flops_total"] > 0
