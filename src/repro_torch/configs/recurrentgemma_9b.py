"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; unverified]  38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000. Local attention window 2048 (Griffin). NSA/SSV applicability:
partial — see DESIGN.md §Arch-applicability."""
from repro_torch.config import ModelConfig, NSAConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, d_ff=12288,
    vocab_size=256000, max_seq_len=524800,
    attention="swa", window=2048, activation="geglu",
    block_pattern=("rglru", "rglru", "attn"),
    recurrent=RecurrentConfig(kind="rglru", conv_width=4),
    nsa=NSAConfig(), dtype="bfloat16",
)

# long-context decode is native (recurrence + windowed attention)
DRYRUN = {"train_4k": {"micro_batches": 4}, "long_500k": {"native": True}}
