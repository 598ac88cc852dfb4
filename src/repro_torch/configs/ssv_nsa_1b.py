"""The paper's 1B-class NSA target model (§7: 32 query heads, 8 KV heads,
head dim 64; NSA l=32 d=16 l'=64 n=16 w=512), llama3-1B-like backbone."""
from repro_torch.config import ModelConfig, NSAConfig

CONFIG = ModelConfig(
    name="ssv-nsa-1b",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=6144, vocab_size=32768, max_seq_len=65536,
    attention="nsa", activation="swiglu",
    nsa=NSAConfig(cmp_block=32, cmp_stride=16, sel_block=64, n_selected=16,
                  window=512),
    dtype="bfloat16",
)
