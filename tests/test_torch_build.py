"""The port's CUDA libraries (fastsmc_tpu_torch.engine._build): the decode
kernels' library and the alpha-wall probe's are built apart, each keyed by
its own sources and headers, so an edit to one source rebuilds only the
library that holds it."""

import shutil

import pytest

from fastsmc_tpu_torch.engine import _build
from fastsmc_tpu_torch.probes import alpha_wall

# the edited file: (decode key changes, probe key changes)
EDITS = {"alpha_wall.cu": (False, True), "hmm_forward.cu": (True, False),
         "hmm_common.cuh": (True, True)}


@pytest.mark.parametrize("name", list(EDITS))
def test_library_keys_follow_their_own_sources(name, tmp_path, monkeypatch):
    """In a copy of ``csrc/``, a comment appended to ``name`` changes the
    key of each library that compiles it and of no other; the decode
    library holds the three decode sources and the probe's only its own."""
    assert _build.DECODE.sources == ("hmm_forward.cu", "hmm_backward.cu",
                                     "hmm_reduce.cu")
    assert alpha_wall.LIBRARY.sources == ("alpha_wall.cu",)
    assert _build.DECODE.stem != alpha_wall.LIBRARY.stem
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    libs = (_build.DECODE, alpha_wall.LIBRARY)
    before = [_build.digest(lib) for lib in libs]
    with open(csrc / name, "a") as fh:
        fh.write("// edited\n")
    after = [_build.digest(lib) for lib in libs]
    assert tuple(a != b for a, b in zip(after, before)) == EDITS[name]
