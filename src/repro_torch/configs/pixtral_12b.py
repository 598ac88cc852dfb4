"""pixtral-12b [vlm]: pixtral-ViT frontend (STUB) + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072. input_specs() provides 256 precomputed patch
embeddings (frontend_dim=1024)."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, d_ff=14336,
    vocab_size=131072, max_seq_len=524800,
    attention="dense", activation="swiglu",
    modality="vision", frontend_dim=1024,
    nsa=NSAConfig(), dtype="bfloat16",
)

FRONTEND_LEN = 256
DRYRUN = {"long_500k": {"nsa": True}}
