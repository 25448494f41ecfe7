"""The loader's direct key map on the CPU:

* ``ckpt_torch.port_entries`` gives, key for key and bit for bit, what the
  flax-layout round trip gives (the JAX package's ``convert_tree`` then the
  port's ``convert.params_from_jax``) for every entry table the loader
  reads (the UNet with and without image-prompt keys, the VAE, CLIP, the
  ControlNet, Lite and XS control files), from fp16 and fp32 files; each
  value is a view of the file's tensor;
* ``load_torch_tensors`` keeps the file's dtype and reads what
  ``load_torch_state_dict`` reads;
* ``load_ctrlora`` with no file returns fp32 CPU copies of the modules'
  states (not the modules' tensors), and with files the keys no file
  fills keep the modules' values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ctrlora_tpu.utils import ckpt_torch as jax_bridge
from ctrlora_tpu_torch import configs, convert
from ctrlora_tpu_torch.pipeline import CtrLoraPipeline
from ctrlora_tpu_torch.utils import ckpt_torch as bridge
from ctrlora_tpu_torch.utils import loading


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test run shares the host's cores between
    several test processes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xs_config():
    cfg = configs.tiny_test_config(hint_mode="image")
    return dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, variant="xs", control_model_ratio=0.5))


def _tables():
    tiny = configs.tiny_test_config(n_loras=1)
    ip = dataclasses.replace(tiny.unet, ip_tokens=2)
    lite = dataclasses.replace(tiny.control, variant="lite")
    return {
        "unet": bridge.unet_entries(tiny.unet),
        "unet_ip": bridge.unet_entries(ip, ip=True),
        "unet_encoder": bridge.unet_entries(tiny.unet, decoder=False),
        "vae": bridge.vae_entries(tiny.vae),
        "clip": bridge.clip_entries(tiny.clip),
        "controlnet": bridge.control_entries(tiny.control),
        "lite": bridge.control_entries(lite),
        "xs_control": bridge.xs_control_entries(_xs_config()),
    }


TABLES = _tables()


def _file(entries, dtype, seed):
    """A reference-named state dict of random tensors of the entries'
    shapes: a Linear weight [out, in], a conv weight [out, in, k, k]."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, (tkey, fpath, kind) in enumerate(entries):
        shape = {bridge.T_LINEAR_W: (6, 5), bridge.T_CONV_W: (4, 3, 3, 3)}.get(kind, (7,))
        out[tkey] = torch.randn(shape, generator=gen).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_port_entries_equal_the_flax_round_trip(table, dtype):
    entries = TABLES[table]
    sd = _file(entries, dtype, seed=len(table))
    del sd[entries[0][0]]  # a key the file lacks is left out by both
    tree, missing = jax_bridge.convert_tree({k: v.float().numpy() for k, v in sd.items()},
                                            entries, strict=False)
    want = convert.params_from_jax(tree)
    got = bridge.port_entries(sd, entries)
    assert missing == [entries[0][0]]
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        assert value.dtype == dtype
        assert torch.equal(value.float(), want[key]), key
    # views of the file's tensors: nothing copied
    storages = {t.untyped_storage().data_ptr() for t in sd.values()}
    assert all(v.untyped_storage().data_ptr() in storages for v in got.values())


def test_port_entries_take_numpy_arrays_and_a_prefix():
    entries = TABLES["vae"]
    sd = {"first_stage_model." + k: v.numpy()
          for k, v in _file(entries, torch.float32, seed=3).items()}
    tree, _ = jax_bridge.convert_tree(sd, entries, prefix="first_stage_model.")
    want = convert.params_from_jax(tree)
    got = bridge.port_entries(sd, entries, prefix="first_stage_model.")
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_torch_tensors_keep_the_files_dtype(tmp_path):
    path = str(tmp_path / "f.ckpt")
    sd = {"a": torch.randn(3, 4).half(), "b": torch.randn(5), "c": np.ones((2, 2), np.float64)}
    torch.save({"state_dict": sd, "epoch": 3}, path)
    tensors = bridge.load_torch_tensors(path)
    arrays = bridge.load_torch_state_dict(path)
    assert sorted(tensors) == sorted(arrays) == ["a", "b", "c"]
    assert tensors["a"].dtype == torch.float16 and tensors["c"].dtype == torch.float32
    for k in arrays:
        assert np.array_equal(tensors[k].float().numpy(), arrays[k])


def test_load_ctrlora_copies_what_no_file_fills(tmp_path):
    cfg = configs.tiny_test_config(n_loras=1)
    torch.manual_seed(0)
    pipe = CtrLoraPipeline(cfg, "cpu", fuse_lora=False)
    states = loading.load_ctrlora(pipe)
    for module, state in zip((pipe.unet, pipe.control, pipe.vae, pipe.clip), states):
        own = module.state_dict()
        assert sorted(state) == sorted(own)
        for key, value in state.items():
            assert value.dtype == torch.float32 and value.device.type == "cpu"
            assert torch.equal(value, own[key].float())
            assert value.untyped_storage().data_ptr() != own[key].untyped_storage().data_ptr()
    # an SD file with the VAE alone: the UNet and CLIP keep the modules' values
    vae = bridge.export_tree(pipe.vae.state_dict(), bridge.vae_entries(cfg.vae),
                             "first_stage_model.")
    path = str(tmp_path / "vae_only.ckpt")
    torch.save({k: torch.from_numpy(v).half() + 1 for k, v in vae.items()}, path)
    states = loading.load_ctrlora(pipe, path)
    assert all(torch.equal(v, pipe.unet.state_dict()[k].float()) for k, v in states.unet.items())
    changed = [k for k, v in states.vae.items() if not torch.equal(v, pipe.vae.state_dict()[k])]
    assert len(changed) == len(vae)
