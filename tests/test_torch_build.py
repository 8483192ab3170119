"""``kernels/build.py`` names each library by a hash of its source, the
shared headers and the flags: an edited header must rebuild every
library, so that no stale one is loaded."""
from repro_torch.kernels import build


def test_target_changes_when_a_header_changes(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "ptx.cuh"\n')
    header = tmp_path / "ptx.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first          # stable
    header.write_text("// two\n")
    assert build._target("k") != first
    (tmp_path / "k.cu").write_text('#include "ptx.cuh"\n// edited\n')
    assert build._target("k") not in (first,)


def test_every_source_and_header_exists():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    assert (build.CSRC / "ptx.cuh").is_file()
    assert all(build._target(n).name.startswith(f"{n}-")
               for n in build.SOURCES)
