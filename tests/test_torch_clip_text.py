"""The port's CLIP text tower against the JAX package on the CPU, fp32 with
weights from a numpy seed (rtol 2e-3 / atol 2e-4): each of the five output
layers ('last', 'penultimate', 'hidden' at a negative and a positive
index, 'pooled' at the EOT position, 'projected'), the 3x77-token windowed
encode, and ``CtrLoraPipeline.encode_text`` (prompts through the tokenizer,
one and three windows), which raises on an id outside the vocabulary."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu.configs import CLIPTextConfig as JaxCLIPConfig
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.models.clip import CLIPTextModel as JaxCLIP
from ctrlora_tpu.models.clip import encode_windowed as jax_encode_windowed
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.pipeline import Params

from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.models.clip import CLIPTextModel, encode_windowed
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline

RTOL, ATOL = 2e-3, 2e-4
# a narrow tower with the real vocabulary and window, so tokenizer ids embed
SIZES = dict(vocab_size=49408, hidden_size=64, intermediate_size=128, num_layers=3,
             num_heads=2, max_length=77)
PROMPTS = ["a photo of a cat", " ".join(["mountains and rivers at dawn"] * 20)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test run shares the host's cores between
    several test processes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Numpy weights of the tower with a text projection (the other layers
    take the same tree without it)."""
    shapes = jax.eval_shape(
        lambda k: JaxCLIP(JaxCLIPConfig(**SIZES, layer="projected", projection_dim=32)).init(
            k, jnp.zeros((1, 77), jnp.int32)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        std = 0.02 if name in ("bias", "token_embedding", "position_embedding") \
            else leaf.shape[0] ** -0.5
        return jnp.asarray(std * rng.standard_normal(leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _without_projection(tree):
    return {"params": {k: v for k, v in tree["params"].items() if k != "text_projection"}}


def _ids(n, seed):
    """Token ids as the tokenizer frames them: SOT, a body, EOT padding."""
    rng = np.random.default_rng(seed)
    ids = np.full((2, n), 49407, np.int32)
    for row, length in zip(ids, (9, 40)):
        for w in range(0, n, 77):
            row[w] = 49406
            row[w + 1:w + 1 + length] = rng.integers(1, 49406, length)
    return ids


def _towers(weights, **kw):
    jcfg = JaxCLIPConfig(**SIZES, **kw)
    tree = weights if kw.get("layer") == "projected" else _without_projection(weights)
    model = CLIPTextModel(configs.CLIPTextConfig(**SIZES, **kw)).eval()
    model.load_state_dict(convert.params_from_jax(tree), strict=True)
    return JaxCLIP(jcfg), tree, model


@pytest.mark.parametrize("kw", [
    {"layer": "last"}, {"layer": "penultimate"}, {"layer": "hidden", "layer_idx": -2},
    {"layer": "hidden", "layer_idx": 1}, {"layer": "pooled"},
    {"layer": "projected", "projection_dim": 32}],
    ids=["last", "penultimate", "hidden-2", "hidden1", "pooled", "projected"])
def test_clip_layers_match_jax(weights, kw):
    jmodel, tree, model = _towers(weights, **kw)
    ids = _ids(77, 1)
    want = np.asarray(jmodel.apply(tree, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_clip_layer_arguments_raise():
    with pytest.raises(ValueError, match="layer_idx"):
        CLIPTextModel(configs.CLIPTextConfig(**SIZES, layer="hidden"))
    with pytest.raises(ValueError, match="projection_dim"):
        CLIPTextModel(configs.CLIPTextConfig(**SIZES, layer="projected"))
    with pytest.raises(ValueError, match="unknown layer"):
        CLIPTextModel(configs.CLIPTextConfig(**SIZES, layer="first"))


def test_windowed_encode_matches_jax(weights):
    jmodel, tree, model = _towers(weights, layer="last")
    ids = _ids(3 * 77, 2)
    want = np.asarray(jax_encode_windowed(jmodel.apply, tree, jnp.asarray(ids)))
    with torch.no_grad():
        got = encode_windowed(model, torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 3 * 77, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="multiple of 77"):
        encode_windowed(model, torch.from_numpy(ids[:, :100]))


@pytest.mark.parametrize("windows", [1, 3])
def test_encode_text_matches_jax(weights, windows):
    """The pipeline's prompt path: tokenizer, then one call per window."""
    tree = _without_projection(weights)
    jcfg = dataclasses.replace(jax_tiny(), clip=JaxCLIPConfig(**SIZES))
    want = np.asarray(JaxPipeline(jcfg).encode_text(Params(None, None, None, tree), PROMPTS,
                                                    windows=windows))
    pcfg = dataclasses.replace(configs.tiny_test_config(), clip=configs.CLIPTextConfig(**SIZES))
    pipe = CtrLoraPipeline(pcfg, "cpu")
    pipe.clip.load_state_dict(convert.params_from_jax(tree), strict=True)
    got = pipe.encode_text(PROMPTS, windows=windows).numpy()
    assert got.shape == (2, windows * 77, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="vocab"):
        CtrLoraPipeline(configs.tiny_test_config(), "cpu").encode_text(PROMPTS)
