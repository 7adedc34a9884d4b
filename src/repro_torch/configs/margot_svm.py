"""The paper's own system, MARGOT (Lippi & Torroni 2016), as served by
the two-phase pipeline: claim/evidence SVM detectors and the pairwise
link scorer.  A copy of ``repro.configs.margot_svm``.

Presets mirror the paper's experimental setup: the M1/M2/M3 link-model
sizes of Table 2 (support-vector counts), the batch datasets of Table 1
(sentence counts), and the stream micro-batch period of §6.2.
"""
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.stream import StreamConfig

# phase-1/phase-2 pipeline configuration (feature dim = hashed BoW space)
PIPELINE = PipelineConfig(
    feat_dim=1024,
    claim_capacity=256,
    evid_capacity=512,
    threshold=0.0,            # the paper keeps score > 0 (Listing 1 line 30)
    svm_gamma=0.1,
    svm_coef0=1.0,
    svm_degree=2,             # poly kernel standing in for the SSTK
)

# Table 2: link models (support vectors); scaled 10x down for CPU benches
MODELS_SV = {"M1": 7_085, "M2": 18_604, "M3": 30_363}
MODELS_SV_SCALED = {k: v // 10 for k, v in MODELS_SV.items()}

# Table 1: datasets (sentences)
DATASETS = {"DS1": 9_783, "DS2": 67_917, "DS3": 233_254, "DS4": 466_483}

# §6.2: stream evaluation (100 s micro-batches; windows 100/1000/5000 s),
# scaled 400x (period 0.25 s; windows 1/5/25 s)
STREAM = StreamConfig(period=0.25, capacity=1024, scope="window",
                      window=5.0, ring_capacity=1024)
STREAM_WINDOWS_S = (1.0, 5.0, 25.0)

CONFIG = PIPELINE   # registry-style access
