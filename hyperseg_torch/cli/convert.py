"""Checkpoint converter: a reference .pth -> the shared .npz + .json container.

Counterpart of hyperseg_tpu/cli/convert.py. The state dict goes through
core/torch_import.py (prefixes, counters and coordinate buffers dropped)
and is written by core/checkpoint.py in the container both packages load;
the reference's arch string (hyperseg.models.*) is kept in the sidecar,
and both packages' registries resolve it, so test_fps can rebuild the model
from the file alone.

    python -m hyperseg_torch.cli.convert model_best.pth [out.npz]
"""

from __future__ import annotations

import os

from hyperseg_torch.core import checkpoint as C
from hyperseg_torch.core.torch_import import load_torch_checkpoint


def main(src: str, dst: str = None) -> str:
    state_dict, meta = load_torch_checkpoint(src)
    dst = dst or os.path.splitext(src)[0] + ".npz"
    C.write_params(dst, state_dict, meta)
    print(f"converted {src} -> {dst} ({len(state_dict)} tensors; "
          f"arch={'yes' if 'arch' in meta else 'no'})")
    return dst


def cli():
    import argparse
    p = argparse.ArgumentParser("hyperseg_torch pth->npz converter")
    p.add_argument("src")
    p.add_argument("dst", nargs="?")
    a = p.parse_args()
    main(a.src, a.dst)


if __name__ == "__main__":
    cli()
