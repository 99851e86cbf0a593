"""Object registry and spec strings: build a model from its arch string.

Counterpart of hyperseg_tpu/core/registry.py. A spec is a callable, a
Spec(target, args, kwargs), or a string "pkg.mod.fn(a, b=c)" parsed with
`ast`, whose arguments must be Python literals: nothing is evaluated.

The alias table maps the short module names, the reference's module paths
("hyperseg.models.*", the arch strings its checkpoints store) and the JAX
package's ("hyperseg_tpu.models.*", the arch strings its checkpoints store)
onto this package, so an arch string written by any of the three rebuilds
this package's model. Only the modules this package has are aliased (the
models and the EfficientNet backbone); the data and loss aliases come with
the data and CLI modules. A target that still names `jax` or
`hyperseg_tpu` after aliasing is refused: this package imports neither.
"""

from __future__ import annotations

import ast
import functools
import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

_MODELS = ("hyperseg_v0_1", "hyperseg_v0_2", "hyperseg_v1_0", "hyperseg_v1_0_unify")

KNOWN_ALIASES: Dict[str, str] = {
    **{m: f"hyperseg_torch.models.{m}" for m in _MODELS},
    "efficientnet": "hyperseg_torch.models.backbones.efficientnet",
    # the reference's module paths (its checkpoints' arch strings)
    **{f"hyperseg.models.{m}": f"hyperseg_torch.models.{m}" for m in _MODELS},
    "hyperseg.models.backbones.efficientnet": "hyperseg_torch.models.backbones.efficientnet",
    # the JAX package's (its checkpoints' arch strings)
    **{f"hyperseg_tpu.models.{m}": f"hyperseg_torch.models.{m}" for m in _MODELS},
    "hyperseg_tpu.models.backbones.efficientnet": "hyperseg_torch.models.backbones.efficientnet",
}
# this package's model modules -> the reference's paths, which arch_string
# writes so that both packages rebuild the model from a checkpoint
REFERENCE_PATHS: Dict[str, str] = {
    v: k for k, v in KNOWN_ALIASES.items() if k.startswith("hyperseg.")}
FOREIGN = ("jax", "jaxlib", "hyperseg_tpu")


def resolve_target(path: str) -> Callable:
    """Resolve 'pkg.mod.attr' (or an aliased module path) to a callable."""
    if "." not in path:
        raise ValueError(f"target {path!r} must be a dotted path")
    mod_path, attr = path.rsplit(".", 1)
    mod_path = KNOWN_ALIASES.get(mod_path, mod_path)
    if mod_path.split(".")[0] in FOREIGN:
        raise ValueError(f"target {path!r} names {mod_path!r}, which hyperseg_torch "
                         "does not import and has no alias for")
    module = importlib.import_module(mod_path)
    if not hasattr(module, attr):
        raise AttributeError(f"{mod_path} has no attribute {attr!r}")
    return getattr(module, attr)


def _literal(node: ast.expr):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"spec arguments must be Python literals, got {ast.dump(node)}") from e


@dataclass
class Spec:
    """A deferred, declarative object construction."""
    target: str
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def build(self, *extra_args, **extra_kwargs):
        fn = resolve_target(self.target)
        return fn(*self.args, *extra_args, **{**self.kwargs, **extra_kwargs})

    def with_overrides(self, **kw) -> "Spec":
        return Spec(self.target, self.args, {**self.kwargs, **kw})

    def to_string(self) -> str:
        parts = [repr(a) for a in self.args]
        parts += [f"{k}={v!r}" for k, v in self.kwargs.items()]
        return f"{self.target}({','.join(parts)})"


def parse_spec(text: str) -> Spec:
    """Parse "pkg.mod.fn(1, k=[2, 3])" into a Spec. Literal arguments only."""
    text = text.strip()
    tree = ast.parse(text, mode="eval").body
    if isinstance(tree, ast.Call):
        if not isinstance(tree.func, (ast.Attribute, ast.Name)):
            raise ValueError(f"unsupported spec callee in {text!r}")
        args = tuple(_literal(a) for a in tree.args)
        kwargs = {kw.arg: _literal(kw.value) for kw in tree.keywords}
        return Spec(ast.unparse(tree.func), args, kwargs)
    if isinstance(tree, (ast.Attribute, ast.Name)):
        return Spec(ast.unparse(tree))
    raise ValueError(f"cannot parse spec {text!r}")


def build(spec, *args, **kwargs):
    """Materialize any spec form (string | Spec | callable)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = parse_spec(spec)
    if isinstance(spec, Spec):
        return spec.build(*args, **kwargs)
    if callable(spec):
        return spec(*args, **kwargs)
    raise TypeError(f"cannot build object from {type(spec)}")


def spec_of(obj) -> Optional[Spec]:
    """Spec extraction for arch serialization: a Spec, a string, or a
    functools.partial of a module-level callable with literal arguments."""
    if isinstance(obj, Spec):
        return obj
    if isinstance(obj, str):
        return parse_spec(obj)
    if isinstance(obj, functools.partial):
        fn = obj.func
        return Spec(f"{fn.__module__}.{fn.__qualname__}", tuple(obj.args),
                    dict(obj.keywords))
    if callable(obj):
        return Spec(f"{obj.__module__}.{obj.__qualname__}")
    return None
