"""The port's vision tower (dynamo_tpu_torch/models/vision.py) against the
JAX package's on VisionConfig.tiny: the same weights (biases and norms
drawn at random, so a wrong order of ``* w + b`` or a dropped bias shows)
and the same images give the same image tokens, with and without the
class token and with the 2-layer projector; a CLIP safetensors directory
loads in both packages to the same leaves and encodings; the config and
the random init keep the reference's shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import vision as jv
from dynamo_tpu_torch.models import vision as tv

# f32 on the CPU: the two differ by the order of the sums
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 on the CPU: relative L2 of the port's tokens to the reference's
BF16_REL_L2 = 2e-2


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _randomize(np_params, seed):
    """Biases, norms, class token and position embedding drawn at random
    (init leaves them zeros and ones)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = path[-1].key
        if name.startswith("ln") or name in ("ln_f", "ln_pre"):
            return (1.0 + 0.3 * rng.randn(*x.shape)).astype(x.dtype)
        if name.startswith("b") or name.endswith("_b") or name in (
                "patch_bias", "proj_b", "proj2_b", "cls"):
            return (0.1 * rng.randn(*x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(draw, np_params)


def _with_proj2(np_params, out, seed):
    rng = np.random.RandomState(seed)
    return dict(np_params,
                proj2=(rng.randn(out, out) / np.sqrt(out)).astype(np.float32),
                proj2_b=(0.1 * rng.randn(out)).astype(np.float32))


def _image(cfg, seed):
    return np.random.RandomState(seed).rand(
        cfg.image_size, cfg.image_size, 3).astype(np.float32)


CASES = {
    "patch tokens": dict(),
    "class token": dict(use_class_token=True),
    "proj2": dict(proj2=True),
    "class token proj2 non-square heads": dict(
        use_class_token=True, proj2=True, num_heads=2, out_hidden_size=48),
}


@pytest.mark.parametrize("case", list(CASES))
def test_encode_image_matches_reference(case):
    kw = dict(CASES[case])
    proj2 = kw.pop("proj2", False)
    cfg = jv.VisionConfig.tiny(**kw)
    tcfg = tv.VisionConfig.tiny(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    np_params = _randomize(_np_tree(jv.init_vision_params(cfg, 3)), 4)
    if proj2:
        np_params = _with_proj2(np_params, cfg.out_hidden_size, 5)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = tv.vision_params_from_jax(np_params, device="cpu")
    for seed in (0, 1):
        img = _image(cfg, seed)
        want = np.asarray(jv.encode_image(cfg, jparams, jnp.asarray(img)))
        got = tv.encode_image(tcfg, tparams, torch.from_numpy(img))
        assert got.shape == (cfg.num_patches, cfg.out_hidden_size)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # different images give different tokens
    other = tv.encode_image(tcfg, tparams, _image(cfg, 2)).numpy()
    assert not np.allclose(other, got.numpy())


def test_encode_image_bf16_matches_reference():
    """bf16 weights and activations: the port rounds where the reference
    does (the layernorm's cast before ``* w + b``, the f32 scores and
    P.V products), within BF16_REL_L2."""
    cfg = jv.VisionConfig.tiny(use_class_token=True)
    np_params = _randomize(_np_tree(jv.init_vision_params(cfg, 3)), 4)
    np_params = _with_proj2(np_params, cfg.out_hidden_size, 5)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), np_params)
    tparams = jax.tree.map(
        lambda x: x.to(torch.bfloat16),
        tv.vision_params_from_jax(np_params, device="cpu"))
    img = _image(cfg, 0)
    want = np.asarray(jv.encode_image(cfg, jparams, jnp.asarray(img)),
                      np.float32)
    got = tv.encode_image(cfg, tparams, img)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < BF16_REL_L2, rel


def _clip_state_dict(cfg, prefix, projector, seed):
    """A CLIP-shape tower (+ a LLaVA projector) in HF names, every leaf
    random."""
    rng = np.random.RandomState(seed)
    H, I, P = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    OUT = cfg.out_hidden_size

    def w(*shape, s=0.05):
        return (rng.randn(*shape) * s).astype(np.float32)

    def norm(n):
        return (1.0 + 0.3 * rng.randn(n)).astype(np.float32)

    sd = {
        prefix + "embeddings.patch_embedding.weight": w(H, 3, P, P),
        prefix + "embeddings.class_embedding": w(H, s=0.02),
        prefix + "embeddings.position_embedding.weight":
            w(cfg.num_positions, H, s=0.02),
        prefix + "pre_layrnorm.weight": norm(H),
        prefix + "pre_layrnorm.bias": w(H, s=0.1),
        prefix + "post_layernorm.weight": norm(H),
        prefix + "post_layernorm.bias": w(H, s=0.1),
    }
    if projector:
        sd["multi_modal_projector.linear_1.weight"] = w(OUT, H)
        sd["multi_modal_projector.linear_1.bias"] = w(OUT, s=0.1)
        sd["multi_modal_projector.linear_2.weight"] = w(OUT, OUT)
        sd["multi_modal_projector.linear_2.bias"] = w(OUT, s=0.1)
    for l in range(cfg.num_layers):
        p = f"{prefix}encoder.layers.{l}."
        for nm in ("layer_norm1", "layer_norm2"):
            sd[p + nm + ".weight"] = norm(H)
            sd[p + nm + ".bias"] = w(H, s=0.1)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{nm}.weight"] = w(H, H)
            sd[p + f"self_attn.{nm}.bias"] = w(H, s=0.1)
        sd[p + "mlp.fc1.weight"] = w(I, H)
        sd[p + "mlp.fc1.bias"] = w(I, s=0.1)
        sd[p + "mlp.fc2.weight"] = w(H, I)
        sd[p + "mlp.fc2.bias"] = w(H, s=0.1)
    return sd


@pytest.mark.parametrize("prefix,projector", [
    ("vision_tower.vision_model.", True),
    ("vision_model.", False),
    ("model.vision_tower.vision_model.", True),
], ids=["llava", "bare clip", "nested llava"])
def test_clip_checkpoint_loads_as_reference(tmp_path, prefix, projector):
    """A CLIP safetensors directory written into tmp_path: every leaf the
    port loads (through its own reader) equals the reference's, and both
    encode an image alike (conv -> patch product, [out, in] -> [in, out],
    the optional 2-layer projector or the identity one)."""
    from safetensors.numpy import save_file

    kw = dict(use_class_token=True)
    if not projector:
        kw["out_hidden_size"] = 32   # the tower's width: identity projector
    cfg = jv.VisionConfig.tiny(**kw)
    sd = _clip_state_dict(cfg, prefix, projector, seed=0)
    save_file(sd, str(tmp_path / "model.safetensors"))
    jparams = jv.load_vision_params(cfg, str(tmp_path))
    tparams = tv.load_vision_params(tv.VisionConfig.tiny(**kw),
                                    str(tmp_path), device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(tparams)[0])
    assert jflat.keys() == tflat.keys()
    assert ("proj2" in tparams) == projector
    for k in jflat:
        np.testing.assert_array_equal(tflat[k].numpy(), np.asarray(jflat[k]))
    img = _image(cfg, 1)
    want = np.asarray(jv.encode_image(cfg, jparams, jnp.asarray(img)))
    got = tv.encode_image(cfg, tparams, img).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_checkpoint_without_tower_or_projector_refused(tmp_path):
    from safetensors.numpy import save_file

    save_file({"x": np.zeros(2, np.float32)},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(FileNotFoundError, match="no CLIP vision tower"):
        tv.load_vision_params(tv.VisionConfig.tiny(), str(tmp_path),
                              device="cpu")
    cfg = tv.VisionConfig.tiny(use_class_token=True)   # out 64 != tower 32
    d = tmp_path / "noproj"
    d.mkdir()
    save_file(_clip_state_dict(cfg, "vision_model.", False, 1),
              str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="no multi_modal_projector"):
        tv.load_vision_params(cfg, str(d), device="cpu")


def test_config_and_init_keep_the_reference_shapes():
    hf = {"image_size": 336, "patch_size": 14, "hidden_size": 1024,
          "intermediate_size": 4096, "num_hidden_layers": 24,
          "num_attention_heads": 16, "layer_norm_eps": 1e-6}
    assert dataclasses.asdict(tv.VisionConfig.from_hf(hf, 5120)) == \
        dataclasses.asdict(jv.VisionConfig.from_hf(hf, 5120))
    default = tv.VisionConfig()
    assert (default.num_patches, default.patch_dim, default.head_dim,
            default.out_hidden_size) == (256, 588, 64, 4096)
    for kw in ({}, {"use_class_token": True}):
        cfg = tv.VisionConfig.tiny(**kw)
        j = _np_tree(jv.init_vision_params(jv.VisionConfig.tiny(**kw), 0))
        t = tv.init_vision_params(cfg, 0, device="cpu")
        jshapes = jax.tree.map(lambda x: x.shape, j)
        tshapes = jax.tree.map(lambda x: tuple(x.shape), t)
        assert jshapes == tshapes
        again = tv.init_vision_params(cfg, 0, device="cpu")
        other = tv.init_vision_params(cfg, 1, device="cpu")
        assert torch.equal(t["layers"]["wq"], again["layers"]["wq"])
        assert not torch.equal(t["layers"]["wq"], other["layers"]["wq"])
        # the reference's scales: N(0, 1/fan_in) weights, zero biases,
        # identity norms
        std = float(t["layers"]["w1"].std()) * np.sqrt(cfg.hidden_size)
        assert 0.8 < std < 1.2
        assert not t["layers"]["bq"].any() and t["ln_f"].eq(1).all()
        bf = tv.init_vision_params(cfg, 0, dtype=torch.bfloat16,
                                   device="cpu")
        assert bf["proj"].dtype == torch.bfloat16
