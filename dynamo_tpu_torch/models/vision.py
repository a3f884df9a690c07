"""ViT-style vision encoder for multimodal serving (PyTorch port of the
JAX package's models/vision.py; reference examples/multimodal:
LLaVA/Qwen-VL encode worker, components/encode_worker.py:148).

The patch embedding is one reshape and one product (a convolution whose
stride equals its kernel is a product over flattened patches), then
pre-norm transformer blocks over weights stacked on a leading layer axis
(as models/llama.py), bidirectional attention, and a projector to the
language model's hidden size. The output is a sequence of image tokens
that ``llama.prefill`` takes in place of the ``<image>`` placeholders'
embeddings (``embeds``/``embeds_mask``).

The parameter dict is CLIP-vision-tower shaped (biases, class token,
pre-embedding layernorm, post layernorm, LLaVA-style 2-layer projector),
so real checkpoints load through ``load_vision_params`` (read by the
port's own safetensors reader); random init keeps the same tree with
zero biases and identity norms. ``vision_params_from_jax`` carries the
JAX package's tree across.

Rounding follows the reference: a layernorm normalizes in f32, casts to
the activation dtype, then applies ``* w + b``; the attention scores and
the probabilities times V are f32 products of the activation-dtype
operands; GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    out_hidden_size: int = 4096   # language model hidden size
    layer_norm_eps: float = 1e-5
    # CLIP prepends a learned class token; LLaVA drops it from the
    # projector input (patch tokens only)
    use_class_token: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, out_hidden_size: int = 64, **kw) -> "VisionConfig":
        """CPU-test shapes."""
        base = dict(image_size=16, patch_size=4, hidden_size=32,
                    intermediate_size=64, num_layers=2, num_heads=4,
                    out_hidden_size=out_hidden_size)
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf(cls, d: dict[str, Any],
                out_hidden_size: int = 4096) -> "VisionConfig":
        """From a HF ``vision_config`` section (CLIPVisionConfig keys)."""
        return cls(
            image_size=d.get("image_size", 224),
            patch_size=d.get("patch_size", 14),
            hidden_size=d.get("hidden_size", 1024),
            intermediate_size=d.get("intermediate_size", 4096),
            num_layers=d.get("num_hidden_layers", 24),
            num_heads=d.get("num_attention_heads", 16),
            out_hidden_size=out_hidden_size,
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            use_class_token=True,
        )


def init_vision_params(cfg: VisionConfig, seed: int = 0,
                       dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda") -> Params:
    """Random-init parameters drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (the JAX init's scales; the
    values differ — ``vision_params_from_jax`` shares weights with the
    reference): weights N(0, 1/fan_in), position embedding and class
    token N(0, 0.02^2), zero biases, identity norms."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    kw = dict(dtype=dtype, device=device)

    def rnd(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2] if len(shape) > 1
                                         else shape[-1])
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale).to(dtype)

    params: Params = {
        "patch_embed": rnd(cfg.patch_dim, H),
        "patch_bias": torch.zeros(H, **kw),
        "pos_embed": rnd(cfg.num_positions, H, scale=0.02),
        "ln_pre": torch.ones(H, **kw),
        "ln_pre_b": torch.zeros(H, **kw),
        "layers": {
            "ln1": torch.ones(L, H, **kw), "ln1_b": torch.zeros(L, H, **kw),
            "ln2": torch.ones(L, H, **kw), "ln2_b": torch.zeros(L, H, **kw),
            "wq": rnd(L, H, H), "bq": torch.zeros(L, H, **kw),
            "wk": rnd(L, H, H), "bk": torch.zeros(L, H, **kw),
            "wv": rnd(L, H, H), "bv": torch.zeros(L, H, **kw),
            "wo": rnd(L, H, H), "bo": torch.zeros(L, H, **kw),
            "w1": rnd(L, H, I), "b1": torch.zeros(L, I, **kw),
            "w2": rnd(L, I, H), "b2": torch.zeros(L, H, **kw),
        },
        "ln_f": torch.ones(H, **kw),
        "ln_f_b": torch.zeros(H, **kw),
        "proj": rnd(H, cfg.out_hidden_size),
        "proj_b": torch.zeros(cfg.out_hidden_size, **kw),
    }
    if cfg.use_class_token:
        params["cls"] = rnd(H, scale=0.02)
    return params


def vision_params_from_jax(np_params: Params,
                           device: str | torch.device = "cuda") -> Params:
    """The JAX package's vision tree, given as (nested dicts of) numpy
    arrays (``jax.tree.map(np.asarray, params)``): the layout is already
    ours."""
    from dynamo_tpu_torch.models.llama import params_from_jax

    return params_from_jax(np_params, device)


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def encode_image(cfg: VisionConfig, params: Params, image) -> torch.Tensor:
    """``[H, W, 3]`` float image (0..1; a tensor or a numpy array, moved
    to the params' device) -> ``[num_patches, out_hidden]`` tokens in the
    params' dtype. With a class token it joins the transformer but is
    dropped before the projector (the LLaVA select_feature="patch"
    convention)."""
    c = cfg
    dev = params["patch_embed"].device
    dtype = params["patch_embed"].dtype
    if not torch.is_tensor(image):
        image = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    image = image.to(dev)
    p = c.patch_size
    n = c.image_size // p
    # patchify: [n, p, n, p, 3] -> [n*n, p*p*3], flattened (p_h, p_w, chan)
    patches = image.reshape(n, p, n, p, 3).permute(0, 2, 1, 3, 4)
    patches = patches.reshape(n * n, c.patch_dim)
    h = patches.to(dtype) @ params["patch_embed"] + params["patch_bias"]
    if c.use_class_token:
        h = torch.cat([params["cls"][None], h], dim=0)
    h = h + params["pos_embed"]
    h = _ln(h, params["ln_pre"], params["ln_pre_b"], c.layer_norm_eps)

    nh, hd = c.num_heads, c.head_dim
    N = h.shape[0]
    lay = params["layers"]
    for l in range(c.num_layers):
        lp = {k: v[l] for k, v in lay.items()}
        x = _ln(h, lp["ln1"], lp["ln1_b"], c.layer_norm_eps)
        q = (x @ lp["wq"] + lp["bq"]).view(N, nh, hd).transpose(0, 1)
        k = (x @ lp["wk"] + lp["bk"]).view(N, nh, hd).transpose(0, 1)
        v = (x @ lp["wv"] + lp["bv"]).view(N, nh, hd).transpose(0, 1)
        # f32 products of the activation-dtype operands (the reference's
        # preferred_element_type=f32)
        s = (q.float() @ k.float().transpose(1, 2)) / math.sqrt(hd)
        w = torch.softmax(s, dim=-1)
        attn = w.to(v.dtype).float() @ v.float()          # [nh, N, hd]
        h = h + (attn.to(h.dtype).transpose(0, 1).reshape(N, c.hidden_size)
                 @ lp["wo"] + lp["bo"])
        x2 = _ln(h, lp["ln2"], lp["ln2_b"], c.layer_norm_eps)
        h = h + (_gelu(x2 @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"])

    h = _ln(h, params["ln_f"], params["ln_f_b"], c.layer_norm_eps)
    if c.use_class_token:
        h = h[1:]                 # patch tokens only
    h = h @ params["proj"] + params["proj_b"]
    if "proj2" in params:         # LLaVA 2-layer projector
        h = _gelu(h) @ params["proj2"] + params["proj2_b"]
    return h                      # [num_patches, out_hidden]


# ---------------------------------------------------------------------------
# Checkpoint loading (CLIP vision tower + LLaVA projector names)

_TOWER_PREFIXES = (
    "vision_tower.vision_model.",     # LLaVA checkpoints
    "vision_model.",                  # bare CLIPVisionModel
    "model.vision_tower.vision_model.",
)


def load_vision_params(
    cfg: VisionConfig, model_dir: str, dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> Params:
    """Load a CLIP-shape vision tower (+ optional LLaVA
    ``multi_modal_projector``) from a HF model directory's safetensors,
    read by the port's own reader (safetensors_io.py).

    The conv patch embedding [H, 3, p, p] becomes the patch product
    [p*p*3, H] (flatten order (p_h, p_w, chan), encode_image's
    patchify). Torch linears are [out, in] and transpose, as
    models/llama.py's params_from_state_dict does."""
    from dynamo_tpu_torch.safetensors_io import Checkpoint

    raw = Checkpoint(model_dir)
    prefix = None
    for cand in _TOWER_PREFIXES:
        if any(k.startswith(cand) for k in raw):
            prefix = cand
            break
    if prefix is None:
        raise FileNotFoundError(
            f"no CLIP vision tower found in {model_dir} "
            f"(looked for prefixes {_TOWER_PREFIXES})"
        )

    def get(name: str, default=None) -> torch.Tensor:
        t = raw.get(name)
        return default if t is None else t.float()

    def t(name: str) -> torch.Tensor:
        return raw[prefix + name].float()

    def put(x: torch.Tensor) -> torch.Tensor:
        # a copy: an f32 tensor on the CPU would otherwise stay a view of
        # the file's mapping
        return x.to(device=device, dtype=dtype, copy=True)

    L, H = cfg.num_layers, cfg.hidden_size
    conv = t("embeddings.patch_embedding.weight")      # [H, 3, p, p]
    patch_embed = conv.permute(2, 3, 1, 0).reshape(cfg.patch_dim, H)
    layers: dict[str, list] = {k: [] for k in (
        "ln1", "ln1_b", "ln2", "ln2_b", "wq", "bq", "wk", "bk",
        "wv", "bv", "wo", "bo", "w1", "b1", "w2", "b2",
    )}
    for l in range(L):
        p = f"encoder.layers.{l}."
        layers["ln1"].append(t(p + "layer_norm1.weight"))
        layers["ln1_b"].append(t(p + "layer_norm1.bias"))
        layers["ln2"].append(t(p + "layer_norm2.weight"))
        layers["ln2_b"].append(t(p + "layer_norm2.bias"))
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            layers[f"w{ours}"].append(t(p + f"self_attn.{theirs}.weight").T)
            layers[f"b{ours}"].append(t(p + f"self_attn.{theirs}.bias"))
        layers["w1"].append(t(p + "mlp.fc1.weight").T)
        layers["b1"].append(t(p + "mlp.fc1.bias"))
        layers["w2"].append(t(p + "mlp.fc2.weight").T)
        layers["b2"].append(t(p + "mlp.fc2.bias"))

    params: Params = {
        "patch_embed": put(patch_embed),
        "patch_bias": put(get(prefix + "embeddings.patch_embedding.bias",
                              torch.zeros(H))),
        "pos_embed": put(t("embeddings.position_embedding.weight")),
        "ln_pre": put(get(prefix + "pre_layrnorm.weight", torch.ones(H))),
        "ln_pre_b": put(get(prefix + "pre_layrnorm.bias", torch.zeros(H))),
        "layers": {k: put(torch.stack(v)) for k, v in layers.items()},
        "ln_f": put(t("post_layernorm.weight")),
        "ln_f_b": put(t("post_layernorm.bias")),
    }
    if cfg.use_class_token:
        params["cls"] = put(t("embeddings.class_embedding"))

    proj_w = get("multi_modal_projector.linear_1.weight")
    if proj_w is not None:
        params["proj"] = put(proj_w.T)
        params["proj_b"] = put(get("multi_modal_projector.linear_1.bias",
                                   torch.zeros(proj_w.shape[0])))
        w2 = get("multi_modal_projector.linear_2.weight")
        if w2 is not None:
            params["proj2"] = put(w2.T)
            params["proj2_b"] = put(get("multi_modal_projector.linear_2.bias",
                                        torch.zeros(w2.shape[0])))
    elif cfg.out_hidden_size == H:
        params["proj"] = put(torch.eye(H))
        params["proj_b"] = put(torch.zeros(H))
    else:
        raise ValueError(
            "no multi_modal_projector in checkpoint and out_hidden_size "
            f"{cfg.out_hidden_size} != tower hidden {H}"
        )
    return params
