"""The paper's 8B-class NSA target (Llama3-8B backbone with attention layers
replaced by NSA — §7.2): 32 query heads, 8 KV heads, head dim 128."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="ssv-nsa-8b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, max_seq_len=65536,
    attention="nsa", activation="swiglu",
    nsa=NSAConfig(cmp_block=32, cmp_stride=16, sel_block=64, n_selected=16,
                  window=512),
    dtype="bfloat16",
)
