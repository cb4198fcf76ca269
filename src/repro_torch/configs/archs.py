"""The 10 assigned architectures (+ the paper's own Himeno workload config).

Sources are the public configs cited in the assignment; ``accum`` /
``remat`` / ``accum_dtype`` are *this framework's* memory-fit policy for the
production mesh (derived from the dry-run memory analysis), not properties of
the published models.
"""
from repro_torch.configs.base import ArchConfig, register

# --- MoE -------------------------------------------------------------------

MIXTRAL_8X7B = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_token=2,
    sliding_window=4096,  # SWA per arXiv:2401.04088
    rope_theta=1e6,
    accum=4,
))

GROK_1_314B = register(ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    num_experts=8, experts_per_token=2,
    rope_theta=1e4,
    accum=16, accum_dtype="bfloat16", remat="full",
    optimizer="adafactor",  # 4 B/param state: 314B fits one v5e-256 pod
))

# --- hybrid / ssm -----------------------------------------------------------

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    attn_every=6,  # Mamba2 backbone + shared attention block every 6 blocks
    accum=4,
))

RWKV6_1_6B = register(ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    rwkv_head_size=64, rwkv_decay_rank=64,
))

# --- dense -------------------------------------------------------------------

GRANITE_20B = register(ArchConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_type="gelu",  # GPT-BigCode-style 2-matmul MLP (matches 20B count)
    accum=2,
))

STABLELM_1_6B = register(ArchConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
))

QWEN1_5_110B = register(ArchConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True,  # Qwen1.5 QKV bias
    accum=16,  # optimizer+CE transients leave ~10 GiB for activations
))

LLAMA3_2_3B = register(ArchConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,  # llama3.2 small models tie input/output embeddings
    accum=4,  # replicated-attention transients: mb=64 fits 16 GB/chip
))

# --- enc-dec audio / vlm ------------------------------------------------------

SEAMLESS_M4T_MEDIUM = register(ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    encoder_layers=12,
    frontend="audio",  # speech frontend stubbed: precomputed frame embeddings
))

LLAVA_NEXT_MISTRAL_7B = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    frontend="vision",  # anyres tiling stubbed: precomputed patch embeddings
    frontend_tokens=2880,  # 5 tiles x 576 patches (anyres high-res budget)
    rope_theta=1e6,
    accum=2,
))

ALL_ARCH_NAMES = [
    "mixtral-8x7b", "grok-1-314b", "zamba2-7b", "granite-20b",
    "stablelm-1.6b", "qwen1.5-110b", "llama3.2-3b", "rwkv6-1.6b",
    "seamless-m4t-medium", "llava-next-mistral-7b",
]
