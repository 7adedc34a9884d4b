"""PyTorch port vs the JAX package: the sequence-sharded prefill
(``seqtp``) and flash at a query offset.

* ``kernels.ref.flash_attention_ref`` with the queries at the last S of T
  key positions (causal and window) against JAX's ``flash_attention_jnp``
  at the same offset, given either way JAX gives it: a static
  ``kv_offset`` over a halo-prefixed K/V, and a dynamic
  ``q_offset_dynamic`` over the whole gathered K/V (fp32, 1e-5); and the
  refusals around it on both routes.
* Two-layer reduced internlm2-1.8b and gemma3-4b (its local layer on the
  halo route, its global layer gathered) at S 1,024 under ``seqtp`` on 2
  ranks spawned over gloo: the forward's logits, the prefill's logits and
  caches equal JAX's ``seqtp`` run on 2 forced devices and the port's
  one-rank run (1e-4).  A local window of 700 over 512-position shards
  (W > S_loc): the port keeps the window and equals its one-rank run;
  JAX's gathered branch drops it and differs (ROADMAP.md, Queue 3).
* Kinds S, R, MLA and MoE shard under ``seqtp`` too (their multi-rank
  results against JAX are tests/test_torch_seqshard_coupled.py's).
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.sharding import use_sharding  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: no layer call on any sequence-sharded route
_NO_ROUTES = {"halo": 0, "gather": 0, "latent": 0, "carry": 0, "moe": 0}
TOL = dict(rtol=1e-4, atol=1e-4)
S = 1024


def _qkv(seed, B, S_q, T, H, KV, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S_q, H, hd).astype(np.float32),
            rng.randn(B, T, KV, hd).astype(np.float32),
            rng.randn(B, T, KV, hd).astype(np.float32))


@pytest.mark.parametrize("B,S_loc,off,H,KV,hd,window", [
    (1, 8, 8, 2, 2, 16, 0), (2, 16, 32, 4, 2, 16, 0), (1, 24, 72, 8, 2, 32, 0),
    (2, 16, 16, 4, 4, 16, 5), (1, 32, 64, 4, 1, 16, 40),
    (1, 8, 0, 2, 1, 16, 0)])
def test_flash_at_a_query_offset_equals_jax_gathered(B, S_loc, off, H, KV,
                                                     hd, window):
    """Queries at positions ``off .. off + S_loc - 1`` over the first
    ``off + S_loc`` keys: JAX's ``q_offset_dynamic`` over the whole
    gathered K/V (later keys masked by causality)."""
    T_all = off + S_loc + 16
    q, k, v = _qkv(off + S_loc, B, S_loc, T_all, H, KV, hd)
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window,
                               q_chunk=8, kv_chunk=16,
                               q_offset_dynamic=jnp.int32(off))
    T = off + S_loc
    got = ref.flash_attention_ref(torch.from_numpy(q),
                                  torch.from_numpy(k[:, :T]).contiguous(),
                                  torch.from_numpy(v[:, :T]).contiguous(),
                                  causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got2 = ops.flash_attention(torch.from_numpy(q),
                               torch.from_numpy(k[:, :T]).contiguous(),
                               torch.from_numpy(v[:, :T]).contiguous(),
                               causal=True, window=window)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("B,S_loc,W,H,KV,hd", [
    (1, 16, 4, 2, 2, 16), (2, 32, 16, 4, 2, 16), (1, 24, 24, 4, 1, 32)])
def test_flash_at_a_query_offset_equals_jax_halo(B, S_loc, W, H, KV, hd):
    """A local layer's halo: W keys of the previous shard before the
    shard's own, window W: JAX's static ``kv_offset = -W``."""
    q, k, v = _qkv(W, B, S_loc, W + S_loc, H, KV, hd)
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=W,
                               q_chunk=8, kv_chunk=8, kv_offset=-W,
                               kv_valid=jnp.ones((W + S_loc,), bool))
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_offset_refusals_and_unchanged_calls():
    """A masked call with fewer keys than queries raises on both routes;
    the backward kernel takes a masked call at T > S (Queue 2 item 12):
    the wrapper and the autograd Function reach their CUDA checks, and
    the CPU route's gradients there are the plain attention's; at T == S
    and unmasked T != S the plain version is the attention it was."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 9, 5, 2, 2, 16))
    for causal, window in ((True, 0), (False, 3), (True, 3)):
        with pytest.raises(ValueError, match="a masked call's queries are "
                                             "the last S"):
            ops.flash_attention(q, k, v, causal=causal, window=window)
        with pytest.raises(ValueError, match="the last S of T >= S"):
            fa.flash_attention_bshd(q, k, v, causal=causal, window=window)
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 5, 9, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_bshd(q, k, v, q, q, torch.zeros(1, 5, 2),
                                    causal=True, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        fa.FlashAttention.apply(q, k, v, True, 0)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.flash_attention(*qkv, causal=True, window=3).sum().backward()
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    at = torch.arange(5)[:, None] + 4
    t = torch.arange(9)[None, :]
    sc = torch.einsum("bqhd,bkhd->bhqk", *want[:2]) / 4.0
    sc = sc.masked_fill(~((t <= at) & (t > at - 3)), -2e38)
    torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), want[2]).sum().backward()
    for a, b in zip(qkv, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
    # T == S: the prefill's mask; unmasked T != S: each query sees all keys
    qs, ks, vs = (torch.from_numpy(a) for a in _qkv(3, 1, 6, 6, 2, 2, 16))
    s = torch.einsum("bqhd,bkhd->bhqk", qs, ks) / 4.0
    s = s.masked_fill(~torch.ones(6, 6, dtype=torch.bool).tril(), -2e38)
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vs)
    torch.testing.assert_close(ref.flash_attention_ref(qs, ks, vs), want,
                               rtol=1e-5, atol=1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v, causal=False),
                               want, rtol=1e-5, atol=1e-5)


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.checkpointer import _flatten_with_paths
from repro.configs import get_config
from repro.configs.base import ScanGroup, reduced
from repro.core.sharding import use_sharding
from repro.launch.mesh import compat_make_mesh
from repro.models import api, transformer as tfm

cases = {"internlm2": ("internlm2-1.8b", ("A", "A"), 0),
         "gemma3": ("gemma3-4b", ("L", "G"), 0),
         "wide": ("gemma3-4b", ("L", "G"), 700)}
S = int(sys.argv[2])
res = {}
mesh = compat_make_mesh((1, 2), ("data", "model"))
for name, (arch, pattern, window) in cases.items():
    cfg = reduced(get_config(arch)).replace(
        n_layers=len(pattern), groups=(ScanGroup(pattern, 1),),
        **({"window": window} if window else {}))
    params = jax.jit(lambda k: api.init(k, cfg)[0])(jax.random.PRNGKey(3))
    toks = np.random.RandomState(4).randint(0, cfg.vocab, (2, S)).astype(
        np.int32)
    for k, v in _flatten_with_paths(params)[0].items():
        res[f"{name}/p/{k}"] = np.asarray(v)
    res[name + "/tokens"] = toks
    def run(p, t):
        logits, _ = tfm.forward(p, cfg, tokens=t)
        last, caches = tfm.prefill(p, cfg, t, tfm.init_caches(cfg, 2, S))
        return logits, last, caches
    with use_sharding(mesh, "seqtp"):
        logits, last, caches = jax.jit(run)(params, jnp.asarray(toks))
    res[name + "/logits"] = np.asarray(logits)
    res[name + "/last"] = np.asarray(last)
    for k, v in _flatten_with_paths(caches)[0].items():
        res[f"{name}/c/{k}"] = np.asarray(v)
np.savez(sys.argv[1], **res)
print("JAX-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's seqtp run on 2 forced devices, then the port's on 2 ranks."""
    path = str(tmp_path_factory.mktemp("seqtp") / "jax.npz")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, path, str(S)],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "JAX-OK" in r.stdout, r.stdout + r.stderr
    with np.load(path) as f:
        want = {k: f[k] for k in f.files}
    per_rank = collectives.spawn(ranks.seqtp_rank, 2, backend="gloo",
                                 device="cpu", timeout_s=120, args=(path,),
                                 threads=2)
    got = {case: [r[case] for r in per_rank] for case in ranks.SEQTP_CASES}
    return path, want, got


def _one_rank(path, case):
    cfg, params, toks = ranks.seqtp_inputs(path, case)
    logits, _ = tfm.forward(params, cfg, tokens=toks)
    caches = tfm.init_caches(cfg, toks.shape[0], toks.shape[1], "cpu")
    last, caches = tfm.prefill(params, cfg, toks, caches)
    return logits.numpy(), last.numpy(), {
        k: v.numpy() for k, v in flatten_with_paths(caches).items()}


@pytest.mark.parametrize("case", ["internlm2", "gemma3"])
def test_seqtp_forward_and_prefill_equal_jax_and_one_rank(runs, case):
    path, want, got = runs
    logits1, last1, caches1 = _one_rank(path, case)
    for rank, g in enumerate(got[case]):
        np.testing.assert_allclose(g["logits"], want[case + "/logits"],
                                   **TOL)
        np.testing.assert_allclose(g["logits"], logits1, **TOL)
        np.testing.assert_allclose(g["last"], want[case + "/last"], **TOL)
        np.testing.assert_allclose(g["last"], last1, **TOL)
        assert set(g["caches"]) == set(caches1)
        for k, v in g["caches"].items():
            np.testing.assert_allclose(v, want[f"{case}/c/{k}"], **TOL,
                                       err_msg=k)
            np.testing.assert_allclose(v, caches1[k], **TOL, err_msg=k)
    # a forward and a prefill, each through every layer
    routes = got[case][0]["routes"]
    assert routes == dict(_NO_ROUTES, **(
        {"gather": 4} if case == "internlm2" else {"halo": 2, "gather": 2}))


def test_wide_window_keeps_its_window_where_jax_drops_it(runs):
    """W 700 > S_loc 512: the local layer takes the gathered route; the
    port keeps the window and equals its one-rank run, JAX's differs from
    it (the reference's fault, ROADMAP.md, Queue 3)."""
    path, want, got = runs
    logits1, last1, _ = _one_rank(path, "wide")
    for g in got["wide"]:
        np.testing.assert_allclose(g["logits"], logits1, **TOL)
        np.testing.assert_allclose(g["last"], last1, **TOL)
        assert g["routes"] == dict(_NO_ROUTES, gather=4)
    # positions past the window in the second shard see more keys in JAX
    late = np.abs(want["wide/logits"][:, 712:] - logits1[:, 712:]).max()
    early = np.abs(want["wide/logits"][:, :512] - logits1[:, :512]).max()
    assert late > 1e-2 and early < 1e-4


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"])
def test_coupled_layer_kinds_raise_under_seqtp(arch):
    """Mamba, RG-LRU, MLA and MoE layers no longer raise (Queue 1 item
    14 is done): at a sharded length rank 0 of a (1, 2) mesh computes its
    half of the positions (fake tensors: the collectives' count route, no
    process group), each coupled layer on its own route, and returns the
    whole sequence's logits; at a length JAX does not shard they run
    whole (here, below FLASH_MIN_SEQ).  The multi-rank results against
    JAX are tests/test_torch_seqshard_coupled.py's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import flags
    from repro_torch.launch import dryrun_lib
    from repro_torch.models import attention as attn
    from repro_torch.models import weights
    cfg = reduced(get_config(arch))
    params = api.init(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = abstract_mesh((1, 2), ("data", "model"), rank0=True)
    for key in attn.SEQSHARD_ROUTES:
        attn.SEQSHARD_ROUTES[key] = 0
    with FakeTensorMode():
        fake = weights.empty_params(cfg, "cpu")
        toks = torch.zeros((1, S), dtype=torch.int32)
        with use_sharding(mesh, "seqtp"), dryrun_lib.Counter() as c:
            big, _ = tfm.forward(fake, cfg, tokens=toks)
    assert tuple(big.shape) == (1, S, cfg.padded_vocab) and \
        flags.counted(big) and c.colls
    kinds = [k for g in cfg.groups for k in g.pattern for _ in
             range(g.repeats)]
    want = {"carry": sum(k in "SR" for k in kinds),
            "latent": sum(k == "M" for k in kinds) if cfg.kv_lora_rank
            else 0,
            "moe": sum(k == "M" for k in kinds)}
    assert {k: attn.SEQSHARD_ROUTES[k] for k in want} == want
    with use_sharding(abstract_mesh((1, 2), ("data", "model")), "seqtp"):
        logits, _ = tfm.forward(params, cfg, tokens=torch.zeros(
            (1, 8), dtype=torch.int32))
    assert logits.shape[:2] == (1, 8) and math.isfinite(
        float(logits.float().abs().max()))


@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
def test_weight_sharded_policies_raise_naming_item_14(policy):
    """Item 14's first half is done: under ``tp`` / ``fsdp_tp`` the
    forward computes on rank 0's blocks of a (1, 2) mesh (fake tensors:
    the collectives' count route, no process group) and gives its half of
    the vocab's logits, with one all-reduce over ``model`` for the
    embedding and two a layer (attention's ``wo``, the MLP's
    ``w_down``); nothing names item 14 any more.  The multi-rank results
    against JAX are ``tests/test_torch_tp.py``'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import flags
    from repro_torch.core.broadcast import placement_shardings
    from repro_torch.launch import dryrun_lib
    from repro_torch.models import weights
    from repro_torch.tree import tree_map
    cfg = reduced(get_config("internlm2-1.8b"))
    mesh = abstract_mesh((1, 2), ("data", "model"), rank0=True)
    sh = placement_shardings(weights.param_axes(cfg), mesh, policy)
    with FakeTensorMode():
        params = tree_map(dryrun_lib._local_empty,
                          weights.empty_params(cfg, "meta"), sh)
        toks = torch.zeros((1, 4), dtype=torch.int32)
        with use_sharding(mesh, policy), dryrun_lib.Counter() as c:
            logits, _ = tfm.forward(params, cfg, tokens=toks)
    assert tuple(logits.shape) == (1, 4, cfg.padded_vocab // 2)
    assert flags.counted(logits)
    layers = sum(g.repeats * len(g.pattern) for g in cfg.groups)
    assert [(col["op"], col["group"]) for col in c.colls] == \
        [("all-reduce", 2)] * (1 + 2 * layers)
