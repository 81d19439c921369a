"""Disk hygiene for the port's tests (tests/test_torch_*.py).

The port's CLI tests write full-width files: 165 MB a Siamese model, 494
MB a train state with its Adam moments.  pytest keeps every ``tmp_path``
and ``tmp_path_factory`` directory of a run until the run ends, so under
Tier-1's six workers the files of all tests pile up on one disk, and a
test that writes late fails with ``No space left on device``.

  * ``drop_tmp_path``: import it into a test module (``from torch_tmp
    import drop_tmp_path  # noqa: F401``) and each test's ``tmp_path`` is
    deleted when the test ends, passed or failed;
  * ``dropped``: a module fixture yields from it to have its directory
    deleted at the module's end, whatever its tests did.
"""

import contextlib
import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    """Delete the test's ``tmp_path`` (when it has one) after the test."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@contextlib.contextmanager
def dropped(path):
    """Yield ``path``; delete the directory when the block ends, however it
    ends."""
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)
