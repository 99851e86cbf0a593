"""hyperseg_torch.core and the pretrained loader against the JAX package's.

On the tiny arch of tests/test_cli.py (B0, two decoder levels) at 64x96,
with parameters perturbed so that every BN acts (torch_parity.tiny_jax_params;
the JAX side runs under jax.jit, or jax.eval_shape where only shapes and
the factories' staging count, to keep the file fast): the registry and its alias table, arch
strings, checkpoints written by one package and read by the other (logits
within HyperSeg-M's 2e-3 of the reference std, tests/test_torch_hyperseg_m.py),
the optimizer state, reference .pth files, fold_bn, and `pretrained` /
`weights_path`."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperseg_torch.core import checkpoint as C
from hyperseg_torch.core import registry
from hyperseg_torch.core.convert import jax_to_torch_state_dict, torch_to_jax_params
from hyperseg_torch.models import hyperseg_v1_0 as V1
from hyperseg_torch.models.hypergen import HyperGen

from torch_parity import (TINY_ARCHS, TINY_CLASSES, assert_close_rel, nchw, nhwc,
                          no_pretrained_files, tiny_jax_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FACTORY_KW = dict(levels=2, kernel_sizes=[1, 3], level_channels=[16, 16],
                       expand_ratio=2, weight_groups=[8, 8])
LOGITS_RTOL = 2e-3     # HyperSeg-M's port-vs-JAX tolerance, of the reference std


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, perturbed params, NHWC input, JAX float32 logits NHWC)."""
    jm, params = tiny_jax_params()
    x = np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32)
    return jm, params, x, np.asarray(jax.jit(jm)(params, jnp.asarray(x)))


def jax_shapes(jm):
    """{key: shape} of a JAX model's parameters, by abstract evaluation of
    its init (which also runs the init's staging of loaded tensors)."""
    return {k: tuple(v.shape) for k, v in jax.eval_shape(jm.init, jax.random.PRNGKey(0)).items()}


def port_model(num_classes=TINY_CLASSES, **kw):
    return V1.hyperseg_efficientnet("efficientnet-b0", device="cpu", num_classes=num_classes,
                                    **TINY_FACTORY_KW, **kw)


def port_logits(model, x_nhwc):
    with torch.no_grad():
        return model(torch.from_numpy(nchw(x_nhwc).copy())).numpy()


def test_parse_spec_literals_only():
    from hyperseg_tpu.core import registry as JR
    text = TINY_ARCHS["jax"][:-1] + ", num_classes=5, out_feat_scale=(1.0, 0.25))"
    got, want = registry.parse_spec(text), JR.parse_spec(text)
    assert (got.target, got.args, got.kwargs) == (want.target, want.args, want.kwargs)
    assert got.kwargs["level_channels"] == [16, 16]
    assert registry.parse_spec(got.to_string()) == got
    for code in ("mod.fn(__import__('os').system('x'))", "mod.fn(k=open('f'))",
                 "(lambda: 0)()"):
        with pytest.raises(ValueError):
            registry.parse_spec(code)
        with pytest.raises(ValueError):
            JR.parse_spec(code)


@pytest.mark.parametrize("form", sorted(TINY_ARCHS))
def test_arch_strings_resolve_to_the_port(form):
    """Reference, short-name and hyperseg_tpu.models.* arch strings build
    the port's model, with the JAX model's tensors, key by key and shape."""
    from hyperseg_tpu.core import registry as JR
    model = registry.build(TINY_ARCHS[form], num_classes=5, device="cpu")
    assert isinstance(model, HyperGen) and not model.training
    assert type(model).__module__ == "hyperseg_torch.models.hypergen"
    want = jax_shapes(JR.build(TINY_ARCHS["jax"], num_classes=5))
    got = torch_to_jax_params(model.state_dict())
    assert {k: v.shape for k, v in got.items()} == want


def test_registry_imports_neither_jax_nor_the_jax_package():
    """Resolving the reference and JAX arch strings in a fresh interpreter
    leaves jax and hyperseg_tpu out of sys.modules (the AST check of
    tests/test_torch_train.py cannot see importlib), and a target that
    still names either after aliasing is refused."""
    code = (
        "import sys\n"
        "from hyperseg_torch.core import registry\n"
        f"for arch in {[TINY_ARCHS['reference'], TINY_ARCHS['jax']]!r}:\n"
        "    registry.build(arch, num_classes=3, device='cpu')\n"
        "registry.resolve_target('hyperseg_tpu.models.backbones.efficientnet.efficientnet')\n"
        "for bad in ('hyperseg_tpu.data.camvid.CamVidDataset', 'jax.numpy.zeros'):\n"
        "    try:\n"
        "        registry.resolve_target(bad)\n"
        "    except ValueError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit(f'{bad} resolved')\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'hyperseg_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout


def test_arch_string_from_partial():
    """A partial of the port's factory serializes with the reference's
    module path and without the build keywords; both packages build it."""
    from hyperseg_tpu.core import registry as JR
    p = functools.partial(V1.hyperseg_efficientnet, "efficientnet-b0", device="cpu", seed=3,
                          **TINY_FACTORY_KW)
    s = C.arch_string(p, num_classes=7)
    assert s.startswith("hyperseg.models.hyperseg_v1_0.hyperseg_efficientnet(")
    assert "device" not in s and "seed" not in s
    assert registry.parse_spec(s).build(device="cpu").decoder.num_classes == 7
    assert JR.parse_spec(s).build().decoder.num_classes == 7


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_packages(tiny, tmp_path, direction):
    """A checkpoint written by one package loads in the other and gives its
    float32 logits on the CPU."""
    from hyperseg_tpu.core import checkpoint as JC
    jm, params, x, want = tiny
    meta = {"epoch": 3, "best_iou": 0.5}
    if direction == "jax_to_port":
        arch = TINY_ARCHS["jax"][:-1] + f", num_classes={TINY_CLASSES})"
        JC.save_checkpoint(str(tmp_path), "model", JC.jnp_to_np(params),
                           meta={**meta, "arch": arch}, is_best=True)
        model, got_meta = C.load_model(str(tmp_path / "model_best.npz"), device="cpu")
        assert got_meta == {**meta, "arch": arch}
        got = nhwc(port_logits(model, x))
    else:
        model = port_model()
        model.load_state_dict(jax_to_torch_state_dict(params), strict=True)
        want = nhwc(port_logits(model, x))
        arch = C.arch_string(functools.partial(V1.hyperseg_efficientnet, "efficientnet-b0",
                                               **TINY_FACTORY_KW), num_classes=TINY_CLASSES)
        C.save_checkpoint(str(tmp_path), "model", model, meta={**meta, "arch": arch},
                          is_best=True)
        jmodel, jparams, got_meta = JC.load_model(str(tmp_path / "model_best.npz"))
        assert got_meta == {**meta, "arch": arch} and set(jparams) == set(params)
        got = np.asarray(jax.jit(jmodel)(jparams, jnp.asarray(x)))
    assert os.path.exists(tmp_path / "model_latest.json")
    assert got.shape == (1, 64, 96, TINY_CLASSES)
    assert_close_rel(got, want, LOGITS_RTOL, f"{direction} logits")


def test_optimizer_state_roundtrip(tmp_path):
    """Adam's state after two steps survives save_checkpoint /
    load_opt_state into a fresh optimizer, every entry checked for shape."""
    from hyperseg_torch.train.schedule import poly_lr
    from hyperseg_torch.train.step import make_optimizer
    model = port_model(train=True)
    opt, sched = make_optimizer(model.parameters(), poly_lr(1e-3, 100, 0.9))
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        sched.step()
    C.save_checkpoint(str(tmp_path), "model", model, optimizer=opt, is_best=True)
    fresh, _ = make_optimizer(model.parameters(), poly_lr(1e-3, 100, 0.9))
    C.load_opt_state(str(tmp_path / "model_best.opt.npz"), fresh)
    a, b = opt.state_dict(), fresh.state_dict()
    assert json.dumps(a["param_groups"]) == json.dumps(
        [{**g, "betas": tuple(g["betas"])} for g in b["param_groups"]])
    assert a["state"].keys() == b["state"].keys()
    for i in a["state"]:
        for k, v in a["state"][i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b["state"][i][k])), (i, k)
    other = torch.nn.Linear(3, 3)
    wrong, _ = make_optimizer([torch.nn.Parameter(torch.zeros(7, 3))] +
                              list(model.parameters())[1:], poly_lr(1e-3, 100, 0.9))
    with pytest.raises(ValueError, match="shape"):
        C.load_opt_state(str(tmp_path / "model_latest.opt.npz"), wrong)
    with pytest.raises(ValueError, match="groups"):
        C.load_opt_state(str(tmp_path / "model_latest.opt.npz"),
                         make_optimizer(other.parameters(), poly_lr(1e-3, 100, 0.9))[0])


def test_reference_pth_loads_strictly(tiny, tmp_path):
    """A reference-format .pth (DataParallel prefixes, num_batches_tracked,
    cached coordinate buffers, meta fields) loads strictly through
    load_model, converts through the convert CLI, and gives what the JAX
    importer reads from the same file."""
    from hyperseg_tpu.core import checkpoint as JC
    from hyperseg_tpu.core.torch_import import load_torch_checkpoint
    from hyperseg_torch.cli import convert
    jm, params, x, want = tiny
    sd = {f"module.{k}": v for k, v in jax_to_torch_state_dict(params).items()}
    sd["module.backbone._bn0.num_batches_tracked"] = torch.tensor(7)
    sd["module.decoder.level_1.0.bn1.num_batches_tracked"] = torch.tensor(7)
    sd["module.decoder.coord64_96"] = torch.zeros(1, 2, 64, 96)
    arch = TINY_ARCHS["reference"][:-1] + f", num_classes={TINY_CLASSES})"
    path = str(tmp_path / "model_best.pth")
    torch.save({"state_dict": sd, "arch": arch, "epoch": 9, "best_iou": 0.7,
                "optimizer": {}}, path)
    model, meta = C.load_model(path, device="cpu")
    assert meta == {"epoch": 9, "arch": arch, "best_iou": 0.7}
    assert_close_rel(nhwc(port_logits(model, x)), want, LOGITS_RTOL, "pth logits")
    jparams, _ = load_torch_checkpoint(path)
    got = torch_to_jax_params(model.state_dict())
    assert set(got) == set(jparams)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(jparams[k]), err_msg=k)
    npz = convert.main(path)
    _, jp, jmeta = JC.load_model(npz)
    assert jmeta["arch"] == arch and set(jp) == set(params)
    model2, _ = C.load_model(npz, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 model2.state_dict().values()))


def test_fold_bn_matches_jax(tiny):
    """fold_bn folds the JAX function's pairs into the same tensors (layout
    converted); its folded BNs keep running_var 1 - eps where JAX's keep 1,
    so the folded model's logits equal the unfolded within 1e-5 relative,
    where JAX's folded logits drift by more than 1e-4 (eval BN still scales
    them by rsqrt(1 + eps))."""
    from hyperseg_tpu.core.folding import fold_bn as jax_fold_bn
    from hyperseg_torch.core.folding import fold_bn
    jm, params, x, jax_logits = tiny
    sd = jax_to_torch_state_dict(params)
    folded = fold_bn(sd)
    got, want = torch_to_jax_params(folded), jax.jit(jax_fold_bn)(params)
    assert set(got) == set(want)
    changed = [k for k in sd if not torch.equal(sd[k], folded[k])]
    assert any(k.startswith("backbone._feat_fc_") for k in changed)
    assert any(k.startswith("weight_mapper.") for k in changed)
    for k in got:
        w = np.asarray(want[k])
        if k.endswith(".running_var") and k in changed:
            eps = 1e-3 if k.startswith("backbone.") else 1e-5
            np.testing.assert_array_equal(w, np.ones_like(w), err_msg=k)
            np.testing.assert_array_equal(got[k], np.full_like(w, 1.0 - eps), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=k)
    model = port_model()
    model.load_state_dict(sd, strict=True)
    y0 = port_logits(model, x)
    model.load_state_dict(folded, strict=True)
    y1 = port_logits(model, x)
    assert np.abs(y1 - y0).max() <= 1e-5 * np.abs(y0).max()
    jax_folded = np.asarray(jax.jit(jm)(want, jnp.asarray(x)))
    assert np.abs(jax_folded - jax_logits).max() > 1e-4 * np.abs(jax_logits).max()


def _lukemelas_b0(path):
    """A lukemelas-format EfficientNet-b0 file: the port's B0 backbone state
    dict from seed 5, less the feature compressors the release files do
    not hold, plus the classifier `_fc.*` and the BN counters."""
    from hyperseg_torch.models.backbones.efficientnet import EfficientNet
    from hyperseg_torch.nn.modules import init_params
    m = EfficientNet("efficientnet-b0", device="cpu")
    init_params(m, torch.Generator().manual_seed(5))
    sd = {k: v for k, v in m.state_dict().items() if not k.startswith("_feat_fc_")}
    sd = {**sd, **{k[:-len("running_mean")] + "num_batches_tracked": torch.tensor(1)
                   for k in sd if k.endswith("running_mean")}}
    sd["_fc.weight"] = torch.randn(1000, m.head_ch)
    sd["_fc.bias"] = torch.randn(1000)
    torch.save(sd, str(path))
    return sd


@pytest.mark.parametrize("case", ["no_file", "missing_path", "lukemelas", "wrong_arch",
                                  "load_model_skips"])
def test_pretrained(case, tmp_path, monkeypatch):
    """`pretrained` as the JAX package's: fail loud with no local file or a
    missing explicit path, load a lukemelas file with load_fc=False (the
    backbone tensors the JAX loader takes, the compressors at their init),
    refuse another architecture's file, and not be read by load_model."""
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    from hyperseg_tpu.models.backbones import pretrained as JP
    from hyperseg_torch.models.backbones.pretrained import resolve_pretrained
    cache = no_pretrained_files(monkeypatch, tmp_path)
    monkeypatch.setenv(JP.ENV_DIR, str(cache))
    import hyperseg_tpu.utils.download as dl
    monkeypatch.setattr(dl, "download_url", lambda *a, **k: False)
    if case == "no_file":
        with pytest.raises(RuntimeError, match="pretrained=True"):
            port_model(pretrained=True)
        with pytest.raises(RuntimeError, match="pretrained=True"):
            JV1.hyperseg_efficientnet("efficientnet-b0", pretrained=True, num_classes=3,
                                      **TINY_FACTORY_KW)
    elif case == "missing_path":
        with pytest.raises(RuntimeError, match="does not exist"):
            resolve_pretrained("efficientnet-b0", "/nonexistent/b0.pth")
        with pytest.raises(RuntimeError, match="does not exist"):
            port_model(pretrained=str(tmp_path / "b0.pth"))
    elif case == "lukemelas":
        sd = _lukemelas_b0(cache / "efficientnet-b0-test.pth")
        model = port_model(pretrained=True)
        got = model.state_dict()
        fresh = port_model().state_dict()
        for k, v in sd.items():
            if k.startswith("_fc.") or k.endswith("num_batches_tracked"):
                assert f"backbone.{k}" not in got
            else:
                assert torch.equal(got[f"backbone.{k}"], v), k
        fcs = [k for k in got if "_feat_fc_" in k and k.endswith("0.weight")]
        assert fcs and all(torch.equal(got[k], fresh[k]) for k in fcs)
        jm = JV1.hyperseg_efficientnet("efficientnet-b0", pretrained=True,
                                       num_classes=TINY_CLASSES, **TINY_FACTORY_KW)
        jax_shapes(jm)      # the JAX init's strict check of the staged tensors
        staged, mine = jm._pretrained_backbone, torch_to_jax_params(got)
        assert len(staged) == len(sd) - 2 - sum(k.endswith("num_batches_tracked") for k in sd)
        for k, v in staged.items():
            np.testing.assert_array_equal(mine[k], np.asarray(v), err_msg=k)
    elif case == "wrong_arch":
        _lukemelas_b0(cache / "efficientnet-b1-wrong.pth")
        with pytest.raises(RuntimeError, match="does not match"):
            V1.hyperseg_efficientnet("efficientnet-b1", device="cpu", pretrained=True,
                                     num_classes=3, **TINY_FACTORY_KW)
        with pytest.raises(RuntimeError, match="does not match"):
            jax_shapes(JV1.hyperseg_efficientnet("efficientnet-b1", pretrained=True,
                                                 num_classes=3, **TINY_FACTORY_KW))
    else:
        arch = TINY_ARCHS["reference"][:-1] + ", pretrained=True, num_classes=3)"
        C.save_checkpoint(str(tmp_path), "model", port_model(num_classes=3),
                          meta={"arch": arch})
        model, meta = C.load_model(str(tmp_path / "model_latest.npz"), device="cpu")
        assert meta["arch"] == arch and model.decoder.num_classes == 3


def test_weights_path_takes_the_tensors_that_match(tiny, tmp_path, capsys):
    """weights_path= initializes every tensor whose key and shape match a
    checkpoint of another class count, the rest at init, and reports the
    count the JAX factory reports."""
    from hyperseg_tpu.models import hyperseg_v1_0 as JV1
    _, params, _, _ = tiny
    path = str(tmp_path / "other.npz")
    C.write_params(path, jax_to_torch_state_dict(params))
    model = port_model(num_classes=5, weights_path=path)
    mine = capsys.readouterr().out
    jm = JV1.hyperseg_efficientnet("efficientnet-b0", num_classes=5, weights_path=path,
                                   **TINY_FACTORY_KW)
    shapes = jax_shapes(jm)      # the JAX init's matching, which prints its count
    theirs = capsys.readouterr().out
    n = int(mine.split("=> initialized ")[1].split("/")[0])
    assert mine.strip() == theirs.strip() and 0 < n < len(shapes)
    got = torch_to_jax_params(model.state_dict())
    fresh = torch_to_jax_params(port_model(num_classes=5).state_dict())
    taken = [k for k, v in jm._pretrained_params.items() if shapes.get(k) == v.shape]
    assert len(taken) == n
    for k in got:
        want = params[k] if k in taken else fresh[k]
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
