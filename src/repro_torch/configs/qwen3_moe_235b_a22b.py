"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, thin experts.
[hf:Qwen/Qwen3-30B-A3B; hf]  94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936. Small dispatch group keeps one-hot dispatch overhead bounded
for the thin d_ff (see models/moe.py)."""
from repro_torch.config import ModelConfig, MoEConfig, NSAConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, d_ff=1536,
    vocab_size=151936, max_seq_len=524800,
    attention="dense", activation="swiglu", qk_norm=True,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536, dispatch_group=256),
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"train_4k": {"micro_batches": 8}, "long_500k": {"nsa": True}}
