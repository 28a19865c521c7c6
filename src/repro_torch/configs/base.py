"""Model configuration schema covering all six assigned architecture
families (dense / moe / ssm / hybrid / vlm / audio).

A copy of the JAX package's ``repro/configs/base.py``: the same fields,
values and ``reduced()`` rule, so a configuration means the same model in
both packages.  Every architecture is one :class:`ModelConfig` instance in
its own module (``repro_torch/configs/<arch_id>.py``) citing its source;
tests instantiate ``cfg.reduced()`` (2 layers, d_model ≤ 512, ≤ 4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    # trunk
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_every: int = 1               # MoE FFN every k-th layer (llama4: 2)
    moe_shared_expert: bool = False  # dense shared expert on MoE layers
    moe_impl: str = "einsum"         # "einsum" (GShard) | "sort" (§Perf)
    # SSM (Mamba2-style)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_impl: str = "ssd"            # "ssd" (chunked matmul form, default after §Perf) | "scan"
    # hybrid (zamba2): one *shared* attention block applied every k layers
    attn_every: int = 0
    # xLSTM: which layer indices are sLSTM (others mLSTM)
    slstm_layers: Tuple[int, ...] = ()
    xlstm_proj_factor: float = 2.0
    # attention details
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm "RoPE 2d": rotary on half dim
    window: Optional[int] = None     # sliding-window width (long-context)
    causal: bool = True
    # misc
    norm_eps: float = 1e-5
    norm: str = "rms"                # "rms" | "ln"
    tie_embeddings: bool = False
    scale_embed: bool = False        # multiply embeddings by sqrt(d_model)
    # modality frontend stubs (spec carve-out: embeddings provided)
    frontend: Optional[str] = None   # "vision" | "audio"
    frontend_tokens: int = 256       # patches / frames prepended (vlm)
    encoder_only: bool = False       # hubert: no decode step
    # numerics
    dtype: str = "bfloat16"
    # citation
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def d_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D model-FLOPs)."""
        hd = self.head_dim_
        d = self.d_model
        per_layer = 0
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        ffn_dense = 3 * d * self.d_ff
        for i in range(self.num_layers):
            if self.family in ("dense", "vlm", "audio"):
                per_layer += attn + ffn_dense
            elif self.family == "moe":
                per_layer += attn + self.num_experts * ffn_dense
            elif self.family == "ssm" and self.slstm_layers is not None \
                    and self.d_ff == 0:
                # xLSTM block: qkv+gates+proj within block
                per_layer += int(2 * d * d * self.xlstm_proj_factor) + 4 * d * d
            elif self.family in ("ssm", "hybrid"):
                dssm = self.d_ssm
                per_layer += 2 * d * dssm + dssm * d + dssm * self.ssm_conv \
                    + 2 * dssm * self.ssm_state
                if self.family == "hybrid" and self.attn_every and \
                        (i + 1) % self.attn_every == 0 and i == 0:
                    pass
        if self.family == "hybrid" and self.attn_every:
            per_layer += attn + ffn_dense      # ONE shared block
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return per_layer + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim_
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        ffn = 3 * d * self.d_ff * self.experts_per_token
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * (attn + ffn) + emb

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model ≤ 512, ≤ 4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        if heads % kv:
            kv = 1
        attn_every = min(self.attn_every, 2) if self.attn_every else 0
        layers = 2 * attn_every if attn_every else 2
        if self.moe_every > 1:
            layers = 2 * self.moe_every
        return dataclasses.replace(
            self,
            attn_every=attn_every,
            num_layers=layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            slstm_layers=tuple(i for i in self.slstm_layers if i < 2),
            frontend_tokens=min(self.frontend_tokens, 16),
            window=min(self.window, 64) if self.window else None,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
