"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (attention-free).
[arXiv:2405.04517; unverified]  12L d_model=768 4H d_ff=0 vocab=50304.
NSA/SSV selection inapplicable (no KV cache); speculative verification runs
via recurrent state replay — DESIGN.md §Arch-applicability."""
from repro_torch.config import ModelConfig, NSAConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4, d_ff=0,
    vocab_size=50304, max_seq_len=524800,
    block_pattern=("mlstm", "slstm"),
    recurrent=RecurrentConfig(kind="mlstm", num_heads=4),
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"long_500k": {"native": True}}
