"""PyTorch port vs the JAX package: the checkpointer
(``checkpoint/checkpointer.py``), ``weights.load_checkpoint`` on a
trainer's step, the replay log (``core/fault.py:ReplayLog``) and the
training token stream (``data/text.py:synthetic_tokens``).

Checkpoints cross both ways with equal keys and equal values: bf16
leaves compared by their bits, everything else exactly.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core import fault as jfault  # noqa: E402
from repro.data import text as jtext  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import fault  # noqa: E402
from repro_torch.data import text  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

ARCH = "internlm2-1.8b"


def _bits(a):
    """An array's values, a bf16 one (ml_dtypes or the 2-byte void that
    np.load gives back) as its uint16 bits."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" and \
            a.dtype != np.float16:
        return a.view(np.uint16)
    return a


def _tbits(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t)


@pytest.fixture(scope="module")
def jax_state():
    """JAX's reduced internlm2 in bf16 parameters, and an optimizer state
    that has taken a step (m and v nonzero)."""
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(param_dtype="bfloat16")
    params = jax.jit(lambda k: japi.init(k, jcfg)[0])(jax.random.PRNGKey(0))
    opt = jadamw_init(params)
    opt = opt._replace(step=opt.step + 3,
                       m=jax.tree_util.tree_map(lambda m: m + 0.5, opt.m),
                       v=jax.tree_util.tree_map(lambda v: v + 0.25, opt.v))
    return jcfg, params, opt


def _port_like(jcfg, jparams):
    tcfg = reduced(get_config(ARCH)).replace(param_dtype="bfloat16")
    flat = {k: np.asarray(v)
            for k, v in _flatten_with_paths(jparams)[0].items()}
    return tcfg, weights.params_from_numpy(flat, tcfg, "cpu")


def test_port_checkpoint_restored_by_jax(jax_state, tmp_path):
    jcfg, jparams, jopt = jax_state
    tcfg, tparams = _port_like(jcfg, jparams)
    topt = adamw_init(tparams)
    topt = topt._replace(step=topt.step + 7,
                         m=tree_map(lambda m: m - 2.0, topt.m))
    Checkpointer(str(tmp_path)).save(7, {"params": tparams, "opt": topt})
    meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
    got = JCheckpointer(str(tmp_path)).restore({"params": jparams,
                                                "opt": jopt})
    gflat = _flatten_with_paths(got)[0]
    tflat = flatten_with_paths({"params": tparams, "opt": topt})
    assert sorted(gflat) == sorted(tflat) == meta["keys"]
    assert meta["step"] == 7 and len(meta["keys"]) == 37
    for k, v in tflat.items():
        np.testing.assert_array_equal(_bits(gflat[k]), _tbits(v), err_msg=k)
    assert np.asarray(gflat["params/embedding/table"]).dtype == \
        np.dtype("V2")                      # JAX's own restore: void bf16
    assert np.asarray(gflat["opt/.step"]).dtype == np.int32


def test_jax_checkpoint_restored_by_port(jax_state, tmp_path):
    jcfg, jparams, jopt = jax_state
    JCheckpointer(str(tmp_path)).save(4, {"params": jparams, "opt": jopt})
    tcfg, tparams = _port_like(jcfg, jparams)
    like = {"params": tree_map(torch.zeros_like, tparams),
            "opt": adamw_init(tparams)}
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4 and ck.steps() == [4]
    got = ck.restore(like)
    gflat = flatten_with_paths(got)
    jflat = _flatten_with_paths({"params": jparams, "opt": jopt})[0]
    assert sorted(gflat) == sorted(jflat)
    for k, v in gflat.items():
        ref = flatten_with_paths(like)[k]
        assert v.dtype == ref.dtype and v.device == ref.device, k
        np.testing.assert_array_equal(_tbits(v), _bits(jflat[k]), err_msg=k)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 3


def test_load_checkpoint_reads_a_trainer_step(tmp_path, capsys):
    """``weights.load_checkpoint`` on a step that JAX's ``launch/train.py``
    wrote (``{"params", "opt"}``): it takes the parameters and leaves the
    optimizer state out (a bare parameter tree still loads too:
    tests/test_torch_engine.py::test_load_checkpoint_is_exact)."""
    jtrain.main(["--steps", "2", "--batch", "2", "--seq", "8",
                 "--ckpt-dir", str(tmp_path)])
    assert "[train] done; checkpoints at [2]" in capsys.readouterr().out
    step_dir = tmp_path / "step_2"
    with np.load(step_dir / "arrays.npz") as data:
        files = {k: data[k] for k in data.files}
    assert any(k.startswith("opt/") for k in files)
    tcfg = reduced(get_config(ARCH))
    params = weights.load_checkpoint(str(step_dir), tcfg, "cpu")
    flat = flatten_with_paths(params)
    assert sorted("params/" + k for k in flat) == sorted(
        k for k in files if k.startswith("params/"))
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), files["params/" + k])


def test_async_save_keep_and_latest(tmp_path):
    """An async save copies to the host before its thread starts: the
    tensor changed right after ``save`` returns is saved as it was.  Only
    the last ``keep`` steps stay; LATEST names the last."""
    ck = Checkpointer(str(tmp_path), async_save=True, keep=2)
    w = torch.zeros(1000)
    for step in range(1, 6):
        w.fill_(float(step))
        ck.save(step, {"w": w, "step": torch.tensor(step, dtype=torch.int32)})
        w.fill_(-1.0)
    ck.wait()
    assert ck.steps() == [4, 5] and ck.latest_step() == 5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    got = ck.restore({"w": torch.empty(1000), "step": torch.tensor(0)})
    assert torch.equal(got["w"], torch.full((1000,), 5.0))
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 5
    got4 = ck.restore({"w": torch.empty(1000, dtype=torch.bfloat16)}, 4)
    assert got4["w"].dtype == torch.bfloat16 and float(got4["w"][0]) == 4.0
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": w})


@pytest.mark.parametrize("like,match", [
    ({"w": torch.empty(999), "step": torch.tensor(0)}, "stored at"),
    ({"w": torch.empty(1000), "step": torch.tensor(0),
      "b": torch.empty(3)}, "missing")])
def test_restore_refuses_another_configs_step(tmp_path, like, match):
    """A step whose leaves do not fit ``like`` (another shape, or a leaf
    it lacks) raises rather than restoring someone else's run."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(1000), "step": torch.tensor(1)})
    with pytest.raises(ValueError, match=match):
        ck.restore(like)


def test_replay_log_equals_jax(tmp_path):
    logs = [fault.ReplayLog(str(tmp_path / "port" / "replay.jsonl")),
            jfault.ReplayLog(str(tmp_path / "jax" / "replay.jsonl"))]
    for log in logs:
        assert log.entries() == [] and log.resume_point(0) is None
        for step in range(4):
            log.record(step, offset=step * 8, note="x")
    ours, theirs = (log.entries() for log in logs)
    strip = lambda es: [{k: v for k, v in e.items() if k != "t"}  # noqa
                        for e in es]
    assert strip(ours) == strip(theirs) and len(ours) == 4
    assert list(ours[0]) == list(theirs[0])          # key order too
    assert logs[0].resume_point(1)["mb_id"] == 2 == \
        logs[1].resume_point(1)["mb_id"]
    assert logs[0].resume_point(3) is None


@pytest.mark.parametrize("seed,vocab", [(0, 92544), (3, 256)])
def test_synthetic_tokens_are_jax_bytes(seed, vocab):
    ours = list(text.synthetic_tokens(seed, 2, 16, vocab, 3))
    theirs = list(jtext.synthetic_tokens(seed, 2, 16, vocab, 3))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.dtype == np.int32 and a.tobytes() == b.tobytes()
