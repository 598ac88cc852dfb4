"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768."""
from repro_torch.config import ModelConfig, MoEConfig, NSAConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, d_ff=16384,
    vocab_size=32768, max_seq_len=524800,
    attention="swa", window=4096, activation="swiglu",
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16384, dispatch_group=1024),
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"train_4k": {"micro_batches": 4}, "long_500k": {"nsa": True}}
