"""granite-20b [dense]: llama-arch code model, MQA. [arXiv:2405.04324; hf]
52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="granite-20b",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, d_ff=24576,
    vocab_size=49152, max_seq_len=524800,
    attention="dense", activation="gelu",
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"train_4k": {"micro_batches": 2}, "long_500k": {"nsa": True}}
