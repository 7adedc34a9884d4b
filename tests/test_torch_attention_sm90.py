"""The edge shapes of the Hopper attention design (64-row, 64-key tiles,
``csrc/attention_sm90.cuh``) held on the CPU: the plain flash and paged
extend attention against the JAX oracles (``repro.kernels.ref``) and the
Pallas kernels in interpret mode, at the tolerances of
tests/test_kernels.py:16.  ``chip_smoke.py`` phase 2 then holds the CUDA
kernels against these plain versions at the same shapes on the card.

Also: both CUDA sources share the header, which has no build-time
options, the wrappers still reject what they rejected, the build's flags
enter the library's name, a reused library keeps nvcc's report, a C entry
point's error codes raise with their meaning, and the A/B timing script
refuses to run without a card.
"""
import functools
import re
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)

_jref_flash = jax.jit(jref.flash_attention_ref,
                      static_argnames=("causal", "window"))
_jpallas_flash = jax.jit(functools.partial(
    jops.flash_attention, block_q=64, block_kv=64, interpret=True),
    static_argnames=("causal", "window"))
_jref_extend = jax.jit(jref.paged_extend_attention_ref)
_jpallas_extend = jax.jit(functools.partial(jops.paged_extend_attention,
                                            interpret=True))

MASKS = [(True, 0), (True, 64), (False, 0)]


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _flash_case(S, H, KV, hd, causal, window, seed):
    q, k, v = _arrays(seed, (2, S, H, hd), (2, S, KV, hd), (2, S, KV, hd))
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        out, np.asarray(_jref_flash(jq, jk, jv, causal=causal,
                                    window=window)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(_jpallas_flash(jq, jk, jv, causal=causal,
                                       window=window)), **TOL)


@pytest.mark.parametrize("S", [63, 64, 65, 129, 200])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_row_and_key_tile_edges(S, causal, window):
    """S one short of, at and one past a 64-row / 64-key tile, two tiles
    and one past, and a ragged 200; G = 4."""
    _flash_case(S, 8, 2, 32, causal, window, seed=S)


@pytest.mark.parametrize("H,KV", [(8, 8), (16, 4), (16, 2)])
def test_flash_group_sizes(H, KV):
    """G = 1, 4 and 8 query heads per kv head share a tile's rows."""
    _flash_case(129, H, KV, 16, True, 0, seed=H * KV)


# (bs, nb, S, pos0): pos0 mid-page, so the suffix and the last visible key
# straddle pages; pos0 + S - 1 past the table's span nb * bs
_EXTEND = [(8, 12, 37, [5, 21, 60]),
           (16, 6, 37, [13, 50, 70]),
           (8, 6, 20, [3, 40, 45]),
           (16, 4, 20, [0, 31, 60])]


@pytest.mark.parametrize("bs,nb,S,pos0", _EXTEND)
@pytest.mark.parametrize("H,KV", [(8, 2), (8, 8)])
def test_extend_page_and_table_edges(bs, nb, S, pos0, H, KV):
    B, hd = len(pos0), 32
    rng = np.random.RandomState(bs * nb + S)
    n_blocks = B * nb + 1
    q = rng.randn(B, S, H, hd).astype(np.float32)
    kp = rng.randn(n_blocks, bs, KV, hd).astype(np.float32)
    vp = rng.randn(n_blocks, bs, KV, hd).astype(np.float32)
    bt = (rng.permutation(n_blocks - 1) + 1).reshape(B, nb).astype(np.int32)
    p0 = np.asarray(pos0, np.int32)
    assert max(p0) + S > nb * bs          # a row runs past the table
    out = ops.paged_extend_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, p0))).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, p0)]
    np.testing.assert_allclose(out, np.asarray(_jref_extend(*args)), **TOL)
    np.testing.assert_allclose(out, np.asarray(_jpallas_extend(*args)),
                               **TOL)


@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "paged_attention.cu"])
def test_sources_share_the_sm90_attention_header(source):
    assert "attention_sm90.cuh" in build.local_includes(source)
    text = (build.CSRC / source).read_text()
    assert "mma.sync" not in text and "mma_bf16" not in text


def test_sm90_header_holds_the_wgmma_and_tma_design():
    text = "".join((build.CSRC / n).read_text() for n in
                   ["attention_sm90.cuh",
                    *build.local_includes("attention_sm90.cuh")])
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait.parity", "cuTensorMapEncodeTiled"):
        assert needle in text, needle


def test_sm90_design_has_no_build_time_options():
    """One design each, no switch between variants: the only conditional
    compilation in the two Hopper headers (the wgmma attention and the
    split-key decode), the PTX header they share and their three sources
    picks the CUDA runtime's entry-point lookup."""
    for name in ("attention_sm90.cuh", "decode_sm90.cuh", "sm90_ptx.cuh",
                 "flash_attention.cu", "paged_attention.cu",
                 "decode_attention.cu"):
        text = (build.CSRC / name).read_text()
        conds = re.findall(r"^\s*#\s*(?:if|ifdef|ifndef|elif)\b(.*)$", text,
                           re.M)
        assert all(c.strip() == "CUDART_VERSION >= 12050" for c in conds), \
            (name, conds)


def _extend_args(**over):
    B, S, H, KV, hd, bs, nb = 2, 3, 4, 2, 16, 8, 3
    args = dict(q=torch.zeros(B, S, H, hd),
                k_pool=torch.zeros(7, bs, KV, hd),
                v_pool=torch.zeros(7, bs, KV, hd),
                block_tables=torch.ones(B, nb, dtype=torch.int32),
                pos0=torch.zeros(B, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("bad", [
    dict(q=torch.zeros(2, 3, 4, 48), k_pool=torch.zeros(7, 8, 2, 48),
         v_pool=torch.zeros(7, 8, 2, 48)),                 # head_dim 48
    dict(q=torch.zeros(2, 3, 4, 16, dtype=torch.float16)),  # dtype
    dict(v_pool=torch.zeros(7, 8, 2, 16, dtype=torch.bfloat16)),  # mixed
    dict(block_tables=torch.ones(2, 3, dtype=torch.int64)),       # int64
    dict(pos0=torch.zeros(3, dtype=torch.int32)),                 # shape
    dict(q=torch.zeros(2, 4, 3, 16).transpose(1, 2)),      # non-contiguous
    dict(q=torch.zeros(2, 3, 3, 16)),                      # 3 heads / 2 kv
    dict(q=torch.zeros(2, 4, 16)),                         # 3-d query
    dict(k_pool=torch.zeros(7, 8, 4, 16), v_pool=torch.zeros(7, 8, 4, 16),
         q=torch.zeros(2, 3, 4, 16)),                      # 4 kv heads, G 1
    dict(q=torch.zeros(2, 3, 4, 16, device="meta")),       # device mix
])
def test_extend_wrapper_rejects(bad):
    args = _extend_args(**bad)
    if args["k_pool"].shape[2] == 4:
        # a legal grouping (G = 1): it runs; the kernel's own wrapper then
        # rejects a query whose kv heads differ from the pools'
        ops.paged_extend_attention(**args)
        with pytest.raises(ValueError, match="kv heads"):
            pa.paged_extend_attention_bkgd(
                args["q"].view(2, 3, 2, 2, 16), args["k_pool"],
                args["v_pool"], args["block_tables"], args["pos0"])
        return
    with pytest.raises(ValueError):
        ops.paged_extend_attention(**args)


def test_extend_kernel_wrapper_takes_cuda_tensors_only():
    a = _extend_args()
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_extend_attention_bkgd(a["q"].view(2, 3, 2, 2, 16),
                                       a["k_pool"], a["v_pool"],
                                       a["block_tables"], a["pos0"])


def test_build_flags_enter_the_library_name(monkeypatch):
    before = {s: build.library_path(s) for s in build.SOURCES}
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = {s: build.library_path(s) for s in build.SOURCES}
    assert all(before[s] != after[s] for s in build.SOURCES)
    assert len(set(after.values())) == len(build.SOURCES)


def test_build_keeps_the_nvcc_report_beside_the_library(tmp_path,
                                                       monkeypatch):
    """A library built by an earlier process still has its ptxas report
    in ``BUILD_LOG``; a library whose report is gone is rebuilt."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("int a;\n")
    fake = tmp_path / "nvcc"
    fake.write_text(f'#!/bin/sh\necho call >> "{tmp_path}/calls"\n'
                    'echo "ptxas info    : Used 128 registers"\n'
                    'while [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
                    '  shift\ndone\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "SOURCES", ("a.cu",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "BUILD_LOG", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: str(fake))
    calls = lambda: (tmp_path / "calls").read_text().count("call")  # noqa
    lib = build.build_all()["a.cu"]
    assert "Used 128 registers" in build.BUILD_LOG["a.cu"] and calls() == 1
    assert build.log_path("a.cu") == lib.with_suffix(".log")
    build.BUILD_LOG.clear()                 # a new process, library built
    assert build.build_all()["a.cu"] == lib and calls() == 1
    assert "Used 128 registers" in build.BUILD_LOG["a.cu"]
    build.log_path("a.cu").unlink()
    assert build.build_all()["a.cu"] == lib and calls() == 2
    assert build.log_path("a.cu").exists()
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        sorted([lib.name, lib.with_suffix(".log").name])


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs on a card")
def test_attention_ab_script_exits_without_a_card():
    script = Path(__file__).resolve().parents[1] / "scripts" / \
        "attention_ab.py"
    done = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0
    assert "attention_ab: no CUDA card" in done.stderr
    assert "[ab]" not in done.stdout


@pytest.mark.parametrize("rc,match", [
    (-1, "no kernel for this dtype"),
    (-2, "cuTensorMapEncodeTiled could not be found"),
    (-3, "refused a TMA tensor map"),
    (700, "CUDA error 700"),
])
def test_launch_errors_raise_with_their_meaning(rc, match):
    with pytest.raises(RuntimeError, match=match):
        kernels.check_launch("paged_extend_attention", rc)
    kernels.check_launch("paged_extend_attention", 0)
