"""musicgen-medium [audio]: decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]  48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048. The EnCodec/text-conditioning frontend is a STUB: input_specs()
provides 64 precomputed conditioning frames (frontend_dim=768)."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, d_ff=6144,
    vocab_size=2048, max_seq_len=524800,
    attention="dense", activation="gelu",
    modality="audio", frontend_dim=768,
    nsa=NSAConfig(), dtype="bfloat16",
)

FRONTEND_LEN = 64
DRYRUN = {"long_500k": {"nsa": True}}
