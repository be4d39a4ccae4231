"""The port's kernel build: library names follow the source, the headers
it includes and the nvcc flags, on the CPU (nothing is compiled here).

A library is reused only when its name matches, so the name must change
when anything the compiler reads or is told changes, and stay the same
otherwise (or every run would rebuild).  Each test works on a copy of
``csrc`` so the checkout's sources are not touched.
"""

import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_every_kernel_source_exists_and_hashes_stably():
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build.library_path(name) == build.library_path(name)
        assert build.library_path(name).parent == build.BUILD_DIR


def test_flash_attention_reads_the_hopper_header():
    names = [p.name for p in build.sources("flash_attention")]
    assert names == ["flash_attention.cu", "sm90.cuh"]
    assert [p.name for p in build.sources("select_topk")] == ["select_topk.cu"]


def test_library_name_changes_with_an_included_header(csrc):
    before = {name: build.library_path(name) for name in build.KERNELS}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.KERNELS}
    assert after["flash_attention"] != before["flash_attention"]
    for name in ("select_topk", "page_migrate", "paged_attention"):
        assert after[name] == before[name]      # they do not include it


def test_library_name_follows_nested_includes(csrc):
    (csrc / "inner.cuh").write_text("// v1\n")
    header = csrc / "sm90.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    first = build.library_path("flash_attention")
    assert (csrc / "inner.cuh") in build.sources("flash_attention")
    (csrc / "inner.cuh").write_text("// v2\n")
    assert build.library_path("flash_attention") != first


def test_library_name_changes_with_the_source(csrc):
    before = build.library_path("page_migrate")
    src = csrc / "page_migrate.cu"
    src.write_text(src.read_text() + "\n")
    assert build.library_path("page_migrate") != before


def test_library_name_changes_with_the_flags(monkeypatch):
    before = {name: build.library_path(name) for name in build.KERNELS}
    monkeypatch.setitem(build.KERNEL_FLAGS, "flash_attention",
                        ("-lineinfo",))
    assert build.library_path("flash_attention") != before["flash_attention"]
    assert build.library_path("select_topk") == before["select_topk"]
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    for name in build.KERNELS:
        assert build.library_path(name) != before[name]


def test_flash_attention_keeps_the_ptxas_report():
    """The tensor-core and cluster kernels keep ptxas's register and spill
    report (chip_smoke.py prints it); the plain copy kernel does not."""
    for name in ("flash_attention", "paged_attention", "select_topk"):
        assert build.flags(name)[-3:] == ("-lineinfo", "-Xptxas", "-v"), name
    assert build.flags("page_migrate") == build.NVCC_FLAGS


def test_build_log_is_empty_before_a_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    assert build.build_log("flash_attention") == ""


def test_flash_ablations_apply_to_the_kernel_source():
    """Each ablation of ``repro_torch.kernels.flash_ablation`` finds its
    text exactly once in the kernel source, so the tool does not rot."""
    from repro_torch.kernels import flash_ablation
    text = (build.CSRC / "flash_attention.cu").read_text()
    for name, old, new in flash_ablation.ABLATIONS:
        assert flash_ablation.ablated_source(text, old, new) != text, name
    with pytest.raises(RuntimeError, match="not found once"):
        flash_ablation.ablated_source(text, "no such text", "")


def test_threads_loading_one_kernel_build_it_once(monkeypatch):
    """8 threads that load one kernel first run one build between them
    (``build`` names its temporary output by pid, so two concurrent builds
    of one kernel would write the same file)."""
    import sys
    import threading
    import time
    calls = []

    def fake_build(names):
        calls.append(tuple(names))
        time.sleep(0.05)            # a build the other threads overlap
        return dict.fromkeys(names, 0.0)

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    got = []
    barrier = threading.Barrier(8)

    def load():
        barrier.wait()
        got.append(build.load("select_topk"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=load) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert calls == [("select_topk",)]
    assert len(got) == 8 and len(set(got)) == 1
