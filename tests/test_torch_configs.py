"""The port's configs (hyperseg_torch/configs/{train,test}/*.py) against the
JAX package's (configs/{train,test}/*.py), and the import check of every
module this slice added.

Each port config's build_kwargs() equals its JAX twin's once every target
is mapped hyperseg_tpu. -> hyperseg_torch.; every transform, criterion and
model (pretrained=False, on the CPU) builds through the port's registry;
train/recipes.RECIPES holds the numbers of the M, L and V configs; in a
fresh interpreter, importing the new modules and loading every config
imports neither JAX nor the JAX package; the CLIs default to the card.
"""

import glob
import importlib.util
import inspect
import os
import subprocess
import sys

import pytest

from hyperseg_torch.core import registry
from hyperseg_torch.train.recipes import RECIPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "hyperseg_torch", "configs")
JAX = os.path.join(ROOT, "configs")
CONFIGS = [(kind, os.path.basename(p)) for kind in ("train", "test")
           for p in sorted(glob.glob(os.path.join(JAX, kind, "*.py")))]
# the modules of the training CLI's slice
NEW_MODULES = ("hyperseg_torch.cli.train", "hyperseg_torch.utils.misc",
               "hyperseg_torch.utils.batch", "hyperseg_torch.utils.profile",
               "hyperseg_torch.ops.meta")


def load_config(path):
    name = "cfg_" + os.path.splitext(os.path.basename(path))[0].replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mapped(obj):
    """The JAX config's value with every target renamed to this package's."""
    from hyperseg_tpu.core.registry import Spec as JSpec
    if isinstance(obj, JSpec):
        return registry.Spec(obj.target.replace("hyperseg_tpu.", "hyperseg_torch."),
                             mapped(obj.args), mapped(obj.kwargs))
    if isinstance(obj, str):
        return obj.replace("hyperseg_tpu.", "hyperseg_torch.")
    if isinstance(obj, dict):
        return {k: mapped(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(mapped(v) for v in obj)
    return obj


def test_every_jax_config_has_a_port_twin():
    """Nine configs: five train, four test, the same file names."""
    port = sorted((k, os.path.basename(p)) for k in ("train", "test")
                  for p in glob.glob(os.path.join(PORT, k, "*.py")))
    assert port == sorted(CONFIGS) and len(port) == 9


@pytest.mark.parametrize("kind,name", CONFIGS, ids=lambda v: v)
def test_config_equals_its_jax_twin(kind, name):
    """build_kwargs() equal to the JAX config's under the target mapping
    (Specs compare by target, args and kwargs), and its main the port's
    CLI."""
    port = load_config(os.path.join(PORT, kind, name))
    want = mapped(load_config(os.path.join(JAX, kind, name)).build_kwargs())
    got = port.build_kwargs()
    assert got == want
    assert port.main.__module__ == f"hyperseg_torch.cli.{kind}"
    assert "hyperseg_tpu" not in repr(got)


@pytest.mark.parametrize("kind,name", CONFIGS, ids=lambda v: v)
def test_config_builds_through_the_port_registry(kind, name):
    """Every transform and the criterion build; a train config's model
    builds on the CPU with pretrained=False, in the config's factory."""
    kw = load_config(os.path.join(PORT, kind, name)).build_kwargs()
    specs = [kw.get("criterion")] + [s for k in ("train_img_transforms", "val_img_transforms",
                                                 "img_transforms", "tensor_transforms")
                                     for s in (kw.get(k) or [])]
    for s in filter(None, specs):
        assert type(registry.build(s)).__module__.startswith("hyperseg_torch."), s
    if kind == "train":
        assert kw["model"].kwargs["pretrained"] is True
        model = registry.build(kw["model"].with_overrides(pretrained=False), device="cpu")
        assert type(model).__module__.startswith("hyperseg_torch.")
        assert model.decoder.hyper_params > 0
        assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.parametrize("key", sorted(RECIPES))
def test_recipes_hold_the_configs_numbers(key):
    """train/recipes.py's crop, batch, lr, PolyLR and schedule mode are the
    port config's."""
    r = RECIPES[key]
    kw = load_config(os.path.join(PORT, "train", r.config)).build_kwargs()
    crop = next((tuple(s.args[0]) for s in kw["train_img_transforms"]
                 if s.target.endswith("RandomCrop")), None)
    pad = next((s.args[0] for s in kw["train_img_transforms"]
                if s.target.endswith("ConstantPad")), None)
    assert r.crop == (crop or (pad, pad))
    assert r.batch == kw["batch_size"]
    assert r.lr == kw["optimizer"]["lr"] and kw["optimizer"]["betas"] == (0.5, 0.999)
    assert r.power == kw["scheduler"]["power"]
    assert r.max_epoch == kw["scheduler"]["max_epoch"]
    assert r.per_batch == kw["batch_scheduler"]
    assert r.steps_per_epoch == kw["train_iterations"] // kw["batch_size"]


def test_new_modules_and_configs_import_no_jax():
    """In a fresh interpreter: the slice's modules imported and every port
    config loaded, sys.modules holds neither jax nor hyperseg_tpu."""
    code = "\n".join([
        "import glob, importlib, importlib.util, os, sys",
        f"sys.path.insert(0, {ROOT!r})",
        f"for m in {NEW_MODULES!r}: importlib.import_module(m)",
        f"for p in sorted(glob.glob(os.path.join({PORT!r}, '*', '*.py'))):",
        "    s = importlib.util.spec_from_file_location('c', p)",
        "    s.loader.exec_module(importlib.util.module_from_spec(s))",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'hyperseg_tpu')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_clis_default_to_the_card():
    """The entry points run on the card unless the caller asks for the CPU."""
    from hyperseg_torch.cli import test as test_cli
    from hyperseg_torch.cli import test_fps
    from hyperseg_torch.cli import train as train_cli
    for fn in (train_cli.main, test_cli.main, test_fps._main_impl):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
