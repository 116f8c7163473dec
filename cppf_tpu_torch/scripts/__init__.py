"""Quality gauges and tools of the port (counterparts of the JAX package's
``scripts/``), each run as ``python -m cppf_tpu_torch.scripts.<name>``."""
from __future__ import annotations

import os
import tempfile
from typing import Optional


def fresh_out_dir(out_dir: Optional[str], prefix: str) -> str:
    """The run's working directory: ``out_dir``, made if it is missing, or
    a new directory under the caller's ``TMPDIR`` when it is None.  Refuses
    an ``out_dir`` that already holds files: the driver reads every frame
    and the eval scores every results pkl it finds there, so what an
    earlier or concurrent run left would enter this run's tables."""
    if out_dir is None:
        return tempfile.mkdtemp(prefix=prefix)
    if os.path.isdir(out_dir) and os.listdir(out_dir):
        raise FileExistsError(f"--out_dir {out_dir} is not empty: give a new or empty "
                              "directory, or none for a fresh one under TMPDIR")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir
