"""Nothing the command imports is JAX or the JAX package, by whole
top-level name."""

import subprocess
import sys

import run

CODE = """
import sys
sys.argv = ["run.py"]
sys.path[:0] = [{here!r}, {root!r}]
import run, control
from lib import serve, train, trace, counts, check, frames, weights
import hyperseg_torch.models.hyperseg_v1_0, hyperseg_torch.models.hyperseg_v1_0_unify
import hyperseg_torch.core.predictor, hyperseg_torch.train.step, hyperseg_torch.train.losses
for name in {metrics!r}:
    run.read_metric(name, {{}})
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_no_jax():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    names = [m["name"] for m in bench["per_layer"]]
    out = subprocess.run([sys.executable, "-c", CODE.format(here=run.HERE, root=run.ROOT,
                                                            metrics=names)],
                         capture_output=True, text=True, check=True, cwd=run.ROOT)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "hyperseg_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)
