"""PyTorch port vs the JAX package: the dry run (``launch/dryrun_lib.py``,
``launch/dryrun.py``), its shape-only API (``models/api.py``'s
``abstract_params`` and ``input_specs``), the kernel ops' and
collectives' count route on fake tensors, and ``kernels/work.py`` against
the kernel table of PERF.md (section 6).
"""
import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import dryrun_lib as jdry  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import ScanGroup, get_config, reduced  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import collectives, flags  # noqa: E402
from repro_torch.kernels import LAUNCHES, build, ops, work  # noqa: E402
from repro_torch.launch import dryrun, dryrun_lib, steps  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import api, weights  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _mesh(*shape):
    return abstract_mesh(shape, ("data", "model"), rank0=True)


# ----------------------------------------------------------------------
def test_shapes_equal_jax():
    assert [tuple(vars(s).values()) for s in base.SHAPES] == \
        [tuple(vars(s).values()) for s in jbase.SHAPES]
    assert base.SHAPE_BY_NAME.keys() == jbase.SHAPE_BY_NAME.keys()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_applicable_and_param_counts_equal_jax(arch):
    """Every shape's applicability, and the parameter counts (total,
    active, experts, embed) of the full-width config, exactly."""
    for s in base.SHAPES:
        assert dryrun_lib.cell_applicable(arch, s.name) == \
            jdry.cell_applicable(arch, s.name)
    assert dryrun_lib.model_param_counts(get_config(arch)) == \
        jdry.model_param_counts(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_have_init_shapes(arch):
    """``abstract_params`` at full width: JAX's leaves' shapes and dtypes,
    on ``meta`` (nothing allocated), JAX's axes; at the reduced width the
    tree ``weights.init_params`` draws, leaf for leaf."""
    params, axes = api.abstract_params(get_config(arch))
    jparams, _ = japi.abstract_params(jax_get_config(arch))
    flat = flatten_with_paths(params)
    jflat = _jax_flat(jparams)
    assert flat.keys() == jflat.keys()
    for k, t in flat.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jflat[k].shape), k
        assert str(t.dtype).split(".")[1] == str(jflat[k].dtype), k
    assert axes == weights.param_axes(get_config(arch))
    cfg = reduced(get_config(arch))
    small, _ = api.abstract_params(cfg)
    drawn = flatten_with_paths(weights.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: (tuple(t.shape), t.dtype) for k, t in
            flatten_with_paths(small).items()} == \
        {k: (tuple(t.shape), t.dtype) for k, t in drawn.items()}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base",
                                  "internvl2-1b"])
def test_input_specs_equal_jax(arch):
    """Each family's specs for every kind: JAX's shapes and dtypes, and a
    batch sharding carried by every leaf."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for kind in ("train", "prefill", "decode"):
        got = api.input_specs(cfg, kind, 3, 300)
        want = japi.input_specs(jcfg, kind, 3, 300)
        assert {k: (tuple(t.shape), str(t.dtype).split(".")[1])
                for k, t in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(t.device.type == "meta" for t in got.values())
        sh = api.input_specs(cfg, kind, 3, 300,
                             batch_sharding=lambda nd: ("rows", nd))
        assert {k: t.sharding for k, t in sh.items()} == \
            {k: ("rows", t.dim()) for k, t in got.items()}


# ----------------------------------------------------------------------
def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.rand(*shape, generator=g, dtype=dtype)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32)

    pool = (r(6, 8, 2, 16), r(6, 8, 2, 16))
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    d = 8
    link = {"W": r(d, d), "w": r(2 * d), "bias": torch.tensor(0.5)}
    return {
        "flash_attention": (
            "flash_attention", lambda q, k, v: ops.flash_attention(
                q, k, v, causal=True, window=6),
            (r(2, 20, 4, 16), r(2, 20, 2, 16), r(2, 20, 2, 16)),
            work.flash_attention(2, 20, 20, 4, 2, 16, dtype="float32",
                                 window=6)),
        "decode_attention": (
            "decode_attention", ops.decode_attention,
            (r(2, 4, 16), r(2, 24, 2, 16), r(2, 24, 2, 16), i32(24, 24)),
            work.decode_attention(2, 4, 2, 16, 24, dtype="float32")),
        "mla_decode_attention": (
            "mla_decode_attention", lambda *a: ops.mla_decode_attention(
                *a, 0.125),
            (r(2, 16, 32), r(2, 16, 8), r(2, 24, 32), r(2, 24, 8),
             i32(24, 24)),
            work.mla_decode_attention(2, 16, 32, 8, 24, dtype="float32")),
        "paged_decode_attention": (
            "paged_decode_attention", ops.paged_decode_attention,
            (r(2, 4, 16), *pool, bt, i32(24, 24)),
            work.paged_decode_attention(2, 4, 2, 16, 8, 3,
                                        dtype="float32")),
        "paged_extend_attention": (
            "paged_extend_attention", ops.paged_extend_attention,
            (r(2, 3, 4, 16), *pool, bt, i32(21, 21)),
            work.paged_extend_attention(2, 3, 4, 2, 16, 8, 3,
                                        dtype="float32")),
        "pair_score": (
            "pair_score", lambda c, e, W, w, b: ops.pair_score(
                {"W": W, "w": w, "bias": b}, c, e),
            (r(5, d), r(7, d), link["W"], link["w"], link["bias"]),
            work.pair_score(5, 7, d, route="wgmma")),
        "ssm_scan": (
            "ssm_scan", ops.ssm_scan,
            (r(2, 5, 6), r(2, 5, 6), r(2, 5, 3), r(2, 5, 3), -r(6, 3), r(6),
             r(2, 6, 3)),
            work.selective_scan(2, 5, 6, 3)),
        "linear_scan": (
            "ssm_scan", ops.linear_scan, (r(2, 5, 6), r(2, 5, 6), r(2, 6)),
            work.ssm_scan(2, 5, 6, 1)),
    }


def _no_build(*a, **k):
    raise AssertionError("the count route built or loaded a kernel")


@pytest.mark.parametrize("op", sorted(_op_cases()))
def test_count_route_matches_plain_shapes(op, monkeypatch):
    """On fake tensors each kernel op returns its plain version's shapes
    and dtypes, reports one call under its kernel's name with
    ``kernels/work.py``'s work to the counter, and builds nothing; it
    launches nothing, so ``kernels.LAUNCHES`` stays at 0."""
    monkeypatch.setattr(build, "load", _no_build)
    name, fn, args, want_work = _op_cases()[op]
    plain = fn(*args)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        ops.reset_counts()
        with dryrun_lib.Counter() as c:
            got = fn(*fake)
    plain_t = plain if isinstance(plain, tuple) else (plain,)
    got_t = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got_t] == \
        [(tuple(t.shape), t.dtype) for t in plain_t]
    assert not any(LAUNCHES.values())
    assert not any(ops.PLAIN_CALLS.values())
    assert c.kernels == {name: [1, want_work.flops, want_work.bytes]}
    assert c.launches() == {name: 1}


def test_count_route_flash_backward_and_refusals(monkeypatch):
    """Flash under autograd on fake tensors: the forward (with its
    log-sum-exp) and the backward counted once each by the counter and
    never in ``kernels.LAUNCHES``, the gradients of the plain version's
    shapes; the refusals of the kernel route hold on the
    count route (a scan input that requires grad, MLA's widths in the
    backward)."""
    monkeypatch.setattr(build, "load", _no_build)
    with FakeTensorMode():
        q = torch.empty(2, 20, 4, 16, requires_grad=True)
        k = torch.empty(2, 20, 2, 16, requires_grad=True)
        v = torch.empty(2, 20, 2, 16, requires_grad=True)
        ops.reset_counts()
        with dryrun_lib.Counter() as c:
            out = ops.flash_attention(q, k, v, causal=True)
            grads = torch.autograd.grad(out.sum(), [q, k, v])
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        with pytest.raises(NotImplementedError, match="Queue 2, item 9"):
            ops.linear_scan(torch.empty(1, 3, 4, requires_grad=True),
                            torch.empty(1, 3, 4), torch.empty(1, 4))
        with pytest.raises(NotImplementedError, match="item 10"):
            qm = torch.empty(1, 8, 2, 192, requires_grad=True)
            ops.flash_attention(qm, torch.empty(1, 8, 2, 192),
                                torch.empty(1, 8, 2, 128))
    fwd = work.flash_attention(2, 20, 20, 4, 2, 16, dtype="float32",
                               lse=True)
    bwd = work.flash_attention_bwd(2, 20, 20, 4, 2, 16, dtype="float32")
    assert c.kernels == {"flash_attention": [1, fwd.flops, fwd.bytes],
                         "flash_attention_bwd": [1, bwd.flops, bwd.bytes]}
    assert not any(LAUNCHES.values())


def test_count_route_without_counter_and_nested_counters(monkeypatch):
    """With no counter active the count route reports nowhere and still
    launches nothing; a counter entered inside another takes the calls
    made under it, and the outer one takes them again once it exits."""
    monkeypatch.setattr(build, "load", _no_build)
    with FakeTensorMode():
        q, k, v = (torch.empty(1, 8, 2, 16) for _ in range(3))
        ops.reset_counts()
        ops.flash_attention(q, k, v)
        assert not any(LAUNCHES.values())
        with dryrun_lib.Counter() as outer:
            ops.flash_attention(q, k, v)
            with dryrun_lib.Counter() as inner:
                ops.flash_attention(q, k, v)
            ops.flash_attention(q, k, v)
        ops.flash_attention(q, k, v)
    assert inner.launches() == {"flash_attention": 1}
    assert outer.launches() == {"flash_attention": 2}
    assert not any(LAUNCHES.values())


# ----------------------------------------------------------------------
_HLO = {
    "all-reduce": "%ar = bf16[64,128]{1,0} all-reduce(bf16[64,128] %x), "
                  "replica_groups=[4,4]<=[16], to_apply=%add",
    "all-gather": "%ag = bf16[64,128]{1,0} all-gather(bf16[16,128] %x), "
                  "replica_groups=[4,4]<=[16], dimensions={0}",
    "reduce-scatter": "%rs = bf16[16,128]{1,0} reduce-scatter(bf16[64,128] "
                      "%x), replica_groups={{0,1,2,3}}, dimensions={0}",
    "all-to-all": "%aa = bf16[64,128]{1,0} all-to-all(bf16[64,128] %x), "
                  "replica_groups={{0,1,2,3}}, dimensions={0}",
    "collective-permute": "%cp = bf16[64,128]{1,0} collective-permute("
                          "bf16[64,128] %x), source_target_pairs={{0,1}}",
}


@pytest.mark.parametrize("op", sorted(_HLO))
def test_wire_formula_equals_jax(op):
    (got,) = jdry.parse_collectives(_HLO[op])
    assert got["op"] == op
    assert flags.wire_bytes(op, got["buf_bytes"], got["group"]) == \
        got["wire_bytes"]


def test_collectives_count_route():
    """On fake tensors over rank 0 of an abstract (4, 4) mesh: each
    collective returns its result's shape, calls no group, and reports
    the HLO op it stands for with JAX's wire bytes; the halo shift is the
    all-gather the port issues."""
    mesh = _mesh(4, 4)
    with FakeTensorMode():
        x = torch.empty(8, 16, dtype=torch.bfloat16)
        with dryrun_lib.Counter() as c:
            shapes = [
                collectives.all_gather(x, "model", mesh=mesh).shape,
                collectives.all_gather(x, ("data", "model"), dim=1,
                                       tiled=False, mesh=mesh).shape,
                collectives.psum(x, "data", mesh=mesh).shape,
                collectives.pmax(x, ("data", "model"), mesh=mesh).shape,
                collectives.ppermute_next(x, "model", mesh=mesh).shape,
                collectives.broadcast(x, mesh=mesh).shape]
    buf = 8 * 16 * 2
    assert shapes == [(32, 16), (8, 16, 16), (8, 16), (8, 16), (8, 16),
                      (8, 16)]
    assert [(r["op"], r["buf_bytes"], r["group"], r["wire_bytes"])
            for r in c.colls] == [
        ("all-gather", 4 * buf, 4, 4 * buf * 3 / 4),
        ("all-gather", 16 * buf, 16, 16 * buf * 15 / 16),
        ("all-reduce", buf, 4, 2 * buf * 3 / 4),
        ("all-reduce", buf, 16, 2 * buf * 15 / 16),
        ("all-gather", 4 * buf, 4, 4 * buf * 3 / 4),
        ("collective-broadcast", buf, 16, buf)]


# ----------------------------------------------------------------------
def test_counter_tracks_storages():
    """Peak bytes of the storages made under the counter, rounded to the
    allocator's 512-byte blocks; a view or an in-place write adds none; a
    freed storage leaves; the inputs made before it are not counted."""
    with FakeTensorMode():
        arg = torch.empty(1000)
        with dryrun_lib.Counter() as c:
            a = arg * 2                       # 4,000 B -> 4,096
            b = a.view(10, 100)               # a view: nothing
            b.add_(1)                         # in place: nothing
            del a, b
            e = torch.empty(10)               # 40 B -> 512
            f = arg[:500].clone()             # 2,000 B -> 2,048
            assert c.live_bytes == 512 + 2048
            del e, f
    assert c.peak_bytes == 4096
    assert c.live_bytes == 0
    assert c.ops["aten.view"] == [1, 0]
    assert c.ops["aten.mul"] == [1, 8000]


def test_train_step_leaves_no_reference_cycle():
    """The train step frees every tensor as its last reference goes, with
    Python's cyclic collector off: the trees' walks are no recursive
    closures (one held a step's gradients, 3.78 GB at internlm2-1.8b's
    full width on the card, until the collector ran), so the card's peak
    is the one the dry run counts, whatever the collector does."""
    import gc
    cfg = _reduced_internlm2(2)
    params = api.init(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw_init(params)
    batch = api.input_batch(cfg, "train", 2, 16,
                            torch.Generator().manual_seed(1), "cpu")
    step = steps.make_train_step(cfg)
    step(params, opt, batch)
    gc.collect()
    gc.disable()
    try:
        out = step(params, opt, batch)
        del out
        assert gc.collect() == 0
    finally:
        gc.enable()


def _reduced_internlm2(repeats):
    cfg = reduced(get_config("internlm2-1.8b"))
    return cfg.replace(groups=(ScanGroup(("A",), repeats),),
                       n_layers=repeats, remat="none")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_full_depth_count_equals_extrapolation(kind):
    """Every trip is counted: the full-depth count equals the
    extrapolation JAX's cost pass makes from its depth samples
    (``repro.launch.dryrun_lib.depth_samples``: cost(base) + (R - 1) *
    (cost(sample) - cost(base))) exactly, in FLOPs, bytes and collectives
    (on a (2, 2) mesh, where the train step all-reduces).  So the port
    needs neither the samples nor JAX's ``COST_MODE``, which has no
    counterpart in ``core/flags.py``."""
    jcfg = jbase.reduced(jax_get_config("internlm2-1.8b")).replace(
        groups=(jbase.ScanGroup(("A",), 3),), n_layers=3)
    jb, ((js, extra),) = jdry.depth_samples(jcfg)
    assert [g.repeats for g in jb.groups] == [1]
    assert [g.repeats for g in js.groups] == [2]
    sc = base.ShapeCase("s", 64, 8, kind)
    mesh = _mesh(2, 2)
    full, bc, sm = (dryrun_lib.count_cell(_reduced_internlm2(r), sc, mesh,
                                          "broadcast") for r in (3, 1, 2))
    for key in ("flops", "bytes", "wire", "ncoll"):
        assert full[key] == bc[key] + extra * (sm[key] - bc[key]), key
    assert full["launches"] == {k: 3 * n for k, n in
                                bc["launches"].items()} != {}
    assert not hasattr(flags, "COST_MODE")


@pytest.mark.parametrize("kind,seq,batch", [("train", 256, 4),
                                            ("prefill", 512, 2),
                                            ("decode", 512, 4)])
def test_flops_near_jax_cost_pass(kind, seq, batch):
    """Reduced internlm2-1.8b (one layer, widened to d_model 512, 8 heads
    of 64 over 4, d_ff 2048, vocab 4096 so that products dominate) on a
    1 x 1 mesh: the port's FLOPs within 10% below JAX's ``cost_pass`` on
    the same ShapeCase, and never above.  They differ because XLA counts
    every elementwise op (norms, rope, softmax, the optimizer) and the
    attention scores of the masked half too, while ``FlopCounterMode``
    counts products alone and the flash kernel only the (query, key)
    pairs its mask lets through."""
    wide = dict(d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
                d_ff=2048, vocab=4096, remat="none")
    jcfg = jbase.reduced(jax_get_config("internlm2-1.8b")).replace(**wide)
    tcfg = reduced(get_config("internlm2-1.8b")).replace(**wide)
    want = jdry.cost_pass(jcfg, jbase.ShapeCase("s", seq, batch, kind),
                          compat_make_mesh((1, 1), ("data", "model")),
                          "broadcast")["flops"]
    got = dryrun_lib.cost_pass(tcfg, base.ShapeCase("s", seq, batch, kind),
                               _mesh(1, 1), "broadcast")["flops"]
    assert 0.90 * want <= got <= want, (got, want, got / want)


def test_run_cell_on_4x4_mesh():
    """Rank 0 of a (4, 4) mesh at full width: ``broadcast`` cells are ok
    (the train cell's gradients all-reduced over the 16 ranks, its
    accumulation from the memory pass); the
    default policies (``fsdp_tp`` for train, ``tp`` for serve) fail,
    naming item 14, as JAX's ``run_cell`` reports a failing cell."""
    mesh = _mesh(4, 4)
    for shape in ("decode_32k", "prefill_32k", "train_4k"):
        res = dryrun_lib.run_cell("internlm2-1.8b", shape, mesh,
                                  policy="broadcast")
        assert res.ok and not res.skipped, res.error
        assert res.mesh == "4x4"
        # 16 rows of 4,096 a rank at remat full take two micro-batches
        assert res.policy == ("broadcast+accum2" if shape == "train_4k"
                              else "broadcast")
        assert res.flops_dev > 0 and res.temp_bytes_dev > 0
        assert res.arg_bytes_dev > 0 and res.out_bytes_dev > 0
        assert res.dominant in ("compute", "memory", "collective")
        assert 0 < res.useful_ratio <= 2.0
        assert (res.n_collectives > 0) == (shape == "train_4k")
        bad = dryrun_lib.run_cell("internlm2-1.8b", shape, mesh)
        assert not bad.ok and "Queue 1, item 14" in bad.error
        assert bad.policy == ("fsdp_tp" if shape == "train_4k" else "tp")
    skip = dryrun_lib.run_cell("internlm2-1.8b", "long_500k", mesh)
    assert skip.ok and skip.skipped


def test_train_accum_from_the_memory_pass(monkeypatch):
    """The accumulation is the smallest power of two that divides the
    rank's rows and fits ``HW["hbm_bytes"]``; the policy carries it."""
    cfg = _reduced_internlm2(1)
    sc = base.ShapeCase("s", 64, 8, "train")
    one = dryrun_lib.count_cell(cfg, sc, _mesh(1, 1), "broadcast")
    two = dryrun_lib.count_cell(cfg, sc, _mesh(1, 1), "broadcast",
                                accum_steps=2)
    assert two["temp_bytes"] < one["temp_bytes"]
    assert two["flops"] == one["flops"]
    monkeypatch.setitem(dryrun_lib.HW, "hbm_bytes",
                        one["arg_bytes"] + two["temp_bytes"])
    accum, got = dryrun_lib.train_accum(cfg, sc, _mesh(1, 1), "broadcast")
    assert accum == 2 and got == two
    monkeypatch.setattr(dryrun_lib, "get_config", lambda arch: cfg)
    res = dryrun_lib.run_cell("internlm2-1.8b", sc, _mesh(1, 1),
                              policy="broadcast", cfg_override={
                                  "remat": "none"})
    assert res.ok and res.policy == "broadcast+accum2", res.error


def test_cli_lines_exit_code_and_results(tmp_path, capsys):
    """JAX's CLI: an OK line and the cell's JSON, SKIP for a long-context
    cell of a full-attention arch, FAIL naming item 14 and exit code 1
    under the default policy; ``--verbose-hlo`` adds the per-op table;
    a memory-only rerun keeps the cost numbers."""
    out = str(tmp_path)
    rc = dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k",
                      "--policy", "broadcast", "--out", out,
                      "--verbose-hlo"])
    text = capsys.readouterr().out
    assert rc == 0
    assert text.splitlines()[0].startswith("OK ")
    assert "pol=broadcast" in text and "kernel:flash_attention_bwd" in text
    path = tmp_path / "internlm2-1.8b__train_4k__16x16__broadcast.json"
    saved = json.loads(path.read_text())
    assert saved["ok"] and saved["flops_dev"] > 0
    assert set(saved) == {f.name for f in
                          dataclasses.fields(jdry.CellResult)}
    rc = dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k",
                      "--policy", "broadcast", "--out", out, "--skip-cost"])
    capsys.readouterr()
    again = json.loads(path.read_text())
    assert rc == 0 and again["flops_dev"] == saved["flops_dev"]
    rc = dryrun.main(["--arch", "internlm2-1.8b", "--shape", "long_500k",
                      "--out", out])
    assert rc == 0 and capsys.readouterr().out.startswith("SKIP ")
    rc = dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k",
                      "--out", out])
    text = capsys.readouterr().out
    assert rc == 1 and text.startswith("FAIL ") and "item 14" in text
    assert "failures: 1" in text


# ----------------------------------------------------------------------
# The kernel table of PERF.md (section 6): each row's shape and the "bound
# ms" it lists, which chip_smoke.py computes with kernels/work.py
_P2 = (2048, 1, 1537, 300, 16, 977, 2000, 64)
_POS0 = (16, 256, 768, 1792)
_HEADS = {"": (16, 8, 128, 0.0085, 0.0072, 0.0056, 0.0085),
          "a": (24, 2, 128, 0.0022, 0.0106, 0.0061, 0.0022),
          "b": (32, 4, 128, 0.0043, 0.0142, 0.0085, 0.0043),
          "c": (14, 2, 64, 0.0011, 0.0031, 0.0019, 0.0011),
          "d": (16, 16, 256, 0.0340, 0.0239, 0.0150, 0.0340),
          "e": (8, 4, 256, 0.0085, 0.0072, 0.0056, 0.0085)}
_ROWS = {}
for _k, (_H, _KV, _hd, _b1, _b2, _b3, _b4) in _HEADS.items():
    _ROWS["1" + _k] = (lambda H=_H, KV=_KV, hd=_hd:
                       work.paged_decode_attention(8, H, KV, hd, 16, 128,
                                                   lengths=_P2), _b1)
    _ROWS["2" + _k] = (lambda H=_H, KV=_KV, hd=_hd:
                       work.paged_extend_attention(4, 256, H, KV, hd, 16,
                                                   128, pos0=_POS0), _b2)
    _ROWS["3" + _k] = (lambda H=_H, KV=_KV, hd=_hd: work.flash_attention(
        3, 512, 512, H, KV, hd), _b3)
    _ROWS["4" + _k] = (lambda H=_H, KV=_KV, hd=_hd: work.decode_attention(
        8, H, KV, hd, 2048, lengths=_P2), _b4)
_ROWS.update({
    "2 verify": (lambda: work.paged_extend_attention(
        8, 4, 16, 8, 128, 16, 32,
        pos0=(301, 307, 314, 318, 322, 325, 329, 510)), 0.0034),
    "3e window": (lambda: work.flash_attention(
        1, 2048, 2048, 8, 4, 256, window=1024), 0.0130),
    "3f": (lambda: work.flash_attention(3, 512, 512, 10, 1, 256), 0.0052),
    "3f window": (lambda: work.flash_attention(
        1, 2200, 2200, 10, 1, 256, window=2048), 0.0249),
    "3g": (lambda: work.flash_attention(3, 512, 512, 16, 16, 192,
                                        hd_v=128), 0.0094),
    "3h": (lambda: work.flash_attention(3, 512, 512, 16, 16, 128), 0.0075),
    "3i": (lambda: work.flash_attention(8, 1500, 1500, 8, 8, 64,
                                        causal=False), 0.0373),
    "3j S 4": (lambda: work.flash_attention(8, 4, 1500, 8, 8, 64,
                                            causal=False), 0.0074),
    "3j S 224": (lambda: work.flash_attention(4, 224, 1500, 8, 8, 64,
                                              causal=False), 0.0042),
    "3k": (lambda: work.flash_attention(1, 2048, 4096, 16, 8, 128), 0.0521),
    "3k halo": (lambda: work.flash_attention(1, 1024, 2048, 8, 4, 256,
                                             window=1024), 0.0087),
    "4f": (lambda: work.decode_attention(8, 10, 1, 256, 2048, lengths=_P2),
           0.0021),
    "4g": (lambda: work.decode_attention(8, 16, 16, 128, 2048, lengths=_P2),
           0.0170),
    "4h self": (lambda: work.decode_attention(
        8, 8, 8, 64, 448, lengths=(5, 68, 127, 128, 129, 300, 447, 448)),
        0.0010),
    "4h cross": (lambda: work.decode_attention(8, 8, 8, 64, 1500), 0.0073),
    "5": (lambda: work.ssm_scan(4, 512, 8192, 16), 0.9628),
    "5a S 512": (lambda: work.ssm_scan(1, 512, 2560, 1), 0.0047),
    "5a S 2200": (lambda: work.ssm_scan(1, 2200, 2560, 1), 0.0202),
    "6 batch": (lambda: work.pair_score(256, 512, 1024), 0.0049),
    "6 stream": (lambda: work.pair_score(1024, 1024, 1024), 0.0261),
    "6 batch cores": (lambda: work.pair_score(256, 512, 1024, route="simt"),
                      0.0120),
    "6 stream cores": (lambda: work.pair_score(1024, 1024, 1024,
                                               route="simt"), 0.0642),
    "7 serve": (lambda: work.mla_decode_attention(
        8, 16, 512, 64, 2048, lengths=range(301, 330, 4)), 0.0009),
    "7 2048 keys": (lambda: work.mla_decode_attention(8, 16, 512, 64, 2048),
                    0.0057),
    "8": (lambda: work.flash_attention_bwd(4, 1024, 1024, 16, 8, 128),
          0.0435),
    "8a": (lambda: work.flash_attention_bwd(1, 2048, 2048, 8, 4, 256,
                                            window=1024), 0.0326),
    "8b cross": (lambda: work.flash_attention_bwd(
        8, 448, 1500, 8, 8, 64, causal=False), 0.0278),
    "8b encoder": (lambda: work.flash_attention_bwd(
        8, 1500, 1500, 8, 8, 64, causal=False), 0.0932),
    "8b decoder": (lambda: work.flash_attention_bwd(8, 448, 448, 8, 8, 64),
                   0.0088),
})


@pytest.mark.parametrize("row", sorted(_ROWS))
def test_work_matches_kernel_table_bounds(row):
    """``kernels/work.py`` at the shapes of each row gives the "bound ms"
    the row lists (to its 4 decimals), so moving the formulas out of
    chip_smoke.py changed no bound."""
    fn, want = _ROWS[row]
    assert f"{fn().bound_ms()[0]:.4f}" == f"{want:.4f}"


def test_work_fused_scan_bound_binds_on_exponentials():
    """Row 5b: the fused selective scan at (4, 512, 8192, 16) is bound by
    its 268 M exponentials at 16 a clock x 132 SMs x 1,980 MHz (0.0642
    ms); its bytes alone 0.0616."""
    w = work.selective_scan(4, 512, 8192, 16)
    assert w.exps == 4 * 512 * 8192 * 16
    assert [f"{x:.4f}" if isinstance(x, float) else x
            for x in w.bound_ms(1980e6)] == ["0.0642", "operations"]
    assert f"{w.bytes / work.HBM_BPS * 1e3:.4f}" == "0.0616"
    assert math.isclose(w.bound_ms()[0], w.bytes / work.HBM_BPS * 1e3)


def test_decode_counts_every_key_without_lengths():
    """Without the lengths on the host the count takes every key: the
    dry run's decode at pos = seq - 1 sees them all."""
    assert work.decode_attention(4, 8, 2, 64, 100) == \
        work.decode_attention(4, 8, 2, 64, 100, lengths=[100] * 4)
