"""smollm-360m [dense]: llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. NOTE: 15 heads does not
divide the 16-way model axis — GSPMD pads (documented in DESIGN.md)."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, d_ff=2560,
    vocab_size=49152, max_seq_len=524800,
    attention="dense", activation="swiglu",
    nsa=NSAConfig(), dtype="bfloat16",
)

DRYRUN = {"long_500k": {"nsa": True}}
