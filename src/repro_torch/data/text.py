"""Text substrate for the MARGOT case study, the port of
``repro.data.text``: sentence splitting (the paper's ``split("[.!?]")``),
hashed bag-of-words featurization (stand-in for the Stanford-parse + BoW
features), and a deterministic synthetic essay corpus standing in for
the Project Gutenberg essays (DS1-DS4, Table 1).

Everything but :func:`margot_models` is a verbatim numpy copy of the JAX
package's module and gives the same arrays byte for byte, the training
token stream :func:`synthetic_tokens` included.
"""
from __future__ import annotations

import hashlib
import re
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import svm as svm_mod

_SENT_SPLIT = re.compile(r"[.!?]")
_TOKEN = re.compile(r"[a-z']+")

# vocabulary flavoring so that synthetic "claims"/"evidence" are learnable
_CLAIM_MARKERS = ["should", "must", "believe", "argue", "clearly", "therefore"]
_EVID_MARKERS = ["survey", "study", "shows", "data", "example", "percent"]
_FILLER = ("the of a to and in that it for on with as at by from up about into "
           "over after beneath under above society people energy policy nature "
           "history science market culture region water matter").split()


def split_sentences(text: str) -> List[str]:
    """The paper's splitter: fileContent.split("[.!?]")."""
    return [s.strip() for s in _SENT_SPLIT.split(text) if s.strip()]


def _hash_idx(token: str, dim: int) -> int:
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little") % dim


def featurize(sentences: Sequence[str], dim: int = 1024) -> np.ndarray:
    """Hashed binary bag-of-words (B, dim), L2-normalized."""
    X = np.zeros((len(sentences), dim), np.float32)
    for i, s in enumerate(sentences):
        for tok in _TOKEN.findall(s.lower()):
            X[i, _hash_idx(tok, dim)] = 1.0
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    return X / np.maximum(norms, 1e-6)


# ----------------------------------------------------------------------
def synthetic_corpus(n_docs: int, sentences_per_doc: int,
                     seed: int = 0) -> List[List[str]]:
    """Deterministic Gutenberg-essay stand-in: ~12% claim-ish, ~30%
    evidence-ish sentences (matching Table 1's DS ratios)."""
    rng = np.random.RandomState(seed)
    docs = []
    for d in range(n_docs):
        doc = []
        for s in range(sentences_per_doc):
            r = rng.rand()
            words = list(rng.choice(_FILLER, size=rng.randint(6, 14)))
            if r < 0.12:
                words.insert(rng.randint(len(words)), rng.choice(_CLAIM_MARKERS))
                words.insert(rng.randint(len(words)), rng.choice(_CLAIM_MARKERS))
            elif r < 0.42:
                words.insert(rng.randint(len(words)), rng.choice(_EVID_MARKERS))
                words.insert(rng.randint(len(words)), rng.choice(_EVID_MARKERS))
            doc.append(" ".join(words))
        docs.append(doc)
    return docs


def corpus_arrays(docs: List[List[str]], dim: int = 1024):
    """Flatten a corpus into (X, doc_ids, sentences)."""
    sents, keys = [], []
    for d, doc in enumerate(docs):
        sents.extend(doc)
        keys.extend([d] * len(doc))
    return featurize(sents, dim), np.asarray(keys, np.int32), sents


def stream_generator(docs: List[List[str]], rate: float, dim: int = 1024,
                     seed: int = 0) -> Iterator[Tuple[float, int, np.ndarray]]:
    """Yield (timestamp, doc_id, feature_row) at `rate` sentences/sec."""
    t = 0.0
    for d, doc in enumerate(docs):
        X = featurize(doc, dim)
        for i in range(len(doc)):
            yield t, d, X[i]
            t += 1.0 / rate


# ----------------------------------------------------------------------
def margot_models(pcfg, link_seed: int = 7, device="cuda"):
    """Deterministic, *discriminative* MARGOT models: linear claim/evidence
    SVMs whose weights are the hashed marker indicators (stand-ins for the
    trained tree-kernel SVMs), plus a link model biased toward
    marker-bearing pairs.

    The claim/evidence SVMs equal the JAX package's.  The link model is
    drawn on the CPU from ``torch.Generator().manual_seed(link_seed)``
    with the JAX distribution (N(0,1)/sqrt(d)) and then moved to
    ``device``, so it is the same on every device; its values differ from
    JAX's ``PRNGKey(link_seed)`` draw.  Returns the model tree (the port
    has no logical-axes tree)."""
    device = resolve_device(device)

    def marker_w(markers):
        w = np.zeros((pcfg.feat_dim,), np.float32)
        for m in markers:
            w[_hash_idx(m, pcfg.feat_dim)] = 1.0
        return w

    link = svm_mod.init_link(torch.Generator().manual_seed(link_seed),
                             pcfg.feat_dim, rank=pcfg.link_rank,
                             device="cpu")
    return {
        "claim": svm_mod.init_linear_svm(marker_w(_CLAIM_MARKERS), -0.15,
                                         device=device),
        "evidence": svm_mod.init_linear_svm(marker_w(_EVID_MARKERS), -0.15,
                                            device=device),
        "link": {k: v.to(device) for k, v in link.items()},
    }


def synthetic_tokens(rng_seed: int, batch: int, seq: int, vocab: int,
                     n_batches: int) -> Iterator[np.ndarray]:
    """Deterministic LM token stream (Zipf-ish) for training examples
    (``text.py:112-120``): ``n_batches`` int32 arrays (batch, seq) from a
    numpy ``RandomState(rng_seed)``, the JAX package's tokens byte for
    byte."""
    rng = np.random.RandomState(rng_seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks ** 1.1
    p /= p.sum()
    for _ in range(n_batches):
        yield rng.choice(vocab, size=(batch, seq), p=p).astype(np.int32)
