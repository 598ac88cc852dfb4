"""nemotron-4-340b [dense]: GQA + squared-ReLU FFN. [arXiv:2402.16819;
unverified]  96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, d_ff=73728,
    vocab_size=256000, max_seq_len=524800,
    attention="dense", activation="squared_relu",
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"train_4k": {"micro_batches": 16},
          "long_500k": {"nsa": True}}  # dense 500K decode skipped; NSA unlocks it
