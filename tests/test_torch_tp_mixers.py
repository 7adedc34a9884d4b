"""PyTorch port vs the JAX package: the tensor-parallel layers (``tp``,
``fsdp_tp``) of the mixers besides attention's: MoE with qk-norm
(qwen3-moe, whose three AdamW steps on (2, 2) split the batch over
``data``: capacity, slots and aux loss are the whole batch's, held
against JAX's whole batch), MLA with a dense first layer and shared
experts (deepseek-v2-lite), Mamba (kind S), the RG-LRU with MQA local
attention (kind R), and the encoder-decoder's self and cross attention
(whisper-base).  The cases, meshes, checks and tolerances are
``test_torch_tp.py``'s (its docstring says what each test holds).
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_tp as tp  # noqa: E402

CASES = ("qwen3moe", "deepseek", "mamba", "rgemma", "whisper")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return tp.make_refs(CASES, str(tmp_path_factory.mktemp("tp") /
                                   "cases.npz"))


@pytest.fixture(scope="module")
def spawned(refs):
    return tp.spawn_meshes(refs, CASES)


@pytest.fixture(params=tp.MESHES, ids=lambda s: "x".join(map(str, s)))
def runs(request, refs, spawned):
    return tp.mesh_runs(refs, spawned, request.param)


def test_logits_loss_and_grads_equal_jax_and_one_rank(runs):
    """The forward's logits, the loss and every leaf's gradient (each
    rank's block, gathered) of every case and policy."""
    tp.check_logits_loss_and_grads(runs)


def test_prefill_and_greedy_decode_equal_one_rank(runs):
    """A prefill and 6 greedy decode steps: the tokens exactly, every
    cache (MLA's latent and attention's whole on every rank, the Mamba
    and RG-LRU states' channels gathered) within 1e-4."""
    tp.check_prefill_and_decode(runs)


def test_three_adamw_steps_equal_one_rank_and_jax(runs):
    """Three AdamW steps against the one-rank run and, for the MoE case,
    JAX's whole batch."""
    tp.check_adamw_steps(runs)
