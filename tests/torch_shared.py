"""A result that several test workers share, computed once per session.

Under pytest-xdist every worker imports every test module, so a
module-scoped fixture runs once in each worker that draws one of its
tests. `shared` keeps the first worker's result in the session's common
temporary directory, under a file lock, and hands it to the others.
"""

import os
import pickle
from contextlib import nullcontext

try:
    from filelock import FileLock
except ImportError:  # pragma: no cover - then each worker computes its own
    FileLock = None


def shared(tmp_path_factory, name, compute):
    """compute() once for the session (a picklable value), by name."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with FileLock(str(path) + ".lock") if FileLock else nullcontext():
        if path.is_file():
            return pickle.loads(path.read_bytes())
        value = compute()
        path.write_bytes(pickle.dumps(value))
        return value
