"""qwen3-8b [dense]: qk_norm + GQA. [hf:Qwen/Qwen3-8B; hf]
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=12288,
    vocab_size=151936, max_seq_len=524800,
    attention="dense", activation="swiglu", qk_norm=True,
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"long_500k": {"nsa": True}}
