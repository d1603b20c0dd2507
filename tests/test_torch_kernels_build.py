"""The name tag of a built kernel library (``ops/kernels.py:source_digest``)
on the CPU: it covers the source, every shared header ``csrc/*.cuh`` and the
nvcc flags, so an edit to a header rebuilds every library that may include
it (the threshold sweep's with the probability header it shares with the
eval accumulator); and every header a source includes is in ``csrc/``."""

import re
import shutil

import pytest

from protnote_tpu_torch.ops import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the digest reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, copy)
    monkeypatch.setattr(kernels, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("edit", ["source", "header", "new_header", "flags", "other_source"])
def test_digest_follows_source_headers_and_flags(csrc, monkeypatch, edit):
    before = kernels.source_digest("pair_scorer")
    assert before == kernels.source_digest("pair_scorer")  # stable
    if edit == "source":
        (csrc / "pair_scorer.cu").write_text((csrc / "pair_scorer.cu").read_text() + "\n// x\n")
    elif edit == "header":
        (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// x\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif edit == "flags":
        monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    else:
        (csrc / "layer_norm.cu").write_text((csrc / "layer_norm.cu").read_text() + "\n// x\n")
    changed = kernels.source_digest("pair_scorer") != before
    assert changed == (edit != "other_source")


@pytest.mark.parametrize("edit", ["source", "sigmoid_header", "other_source"])
def test_sweep_digest_follows_its_source_and_the_shared_sigmoid(csrc, edit):
    """K9's library (``threshold_sweep.cu``) is rebuilt when its source or
    the probability header it shares with K3 changes, not for K3's source."""
    before = kernels.source_digest("threshold_sweep")
    name = {"source": "threshold_sweep.cu", "sigmoid_header": "sigmoid.cuh",
            "other_source": "eval_accumulator.cu"}[edit]
    (csrc / name).write_text((csrc / name).read_text() + "\n// x\n")
    assert (kernels.source_digest("threshold_sweep") != before) == (edit != "other_source")


def test_included_headers_are_shared_headers():
    """Every ``#include "..."`` of a source names a ``csrc/*.cuh`` (the
    digest hashes exactly those), and the Hopper header is shared by the
    kernels that use TMA and wgmma."""
    headers = {p.name for p in kernels.CSRC_DIR.glob("*.cuh")}
    users = {"hopper.cuh": set(), "sigmoid.cuh": set()}
    for src in kernels.CSRC_DIR.glob("*.cu"):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert name in headers, (src.name, name)
            users.setdefault(name, set()).add(src.stem)
    assert {"pair_scorer", "pair_scorer_int8", "pair_train",
            "text_attention"} <= users["hopper.cuh"]
    assert users["sigmoid.cuh"] == {"eval_accumulator", "threshold_sweep"}
    assert users["bn_columns.cuh"] == {"bn_relu", "streamed_bn", "pair_dense"}


def test_streamed_bn_signatures_match_the_c_entry_points():
    """The ctypes signatures of K6's wrappers (``K6_SIGNATURES``) against the
    ``extern "C"`` prototypes of ``csrc/streamed_bn.cu``, parameter by
    parameter: a pointer is ``c_void_p``, ``long long`` ``c_longlong``, an
    int ``c_int`` (ctypes would pass a pointer given as an int cut to 32
    bits).  The kernels run only on a card, so this is checked here."""
    import ctypes

    from protnote_tpu_torch.ops.streaming_train import K6_SIGNATURES

    src = (kernels.CSRC_DIR / "streamed_bn.cu").read_text()
    protos = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(protos) == set(K6_SIGNATURES)
    kinds = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int}
    for name, params in protos.items():
        types = []
        for param in params.split(","):
            decl = " ".join(param.replace("const ", "").split()[:-1])
            types.append(kinds[decl.replace(" *", "*")])
        assert types == K6_SIGNATURES[name], name


def test_kernel_function_sets_its_signature_once(monkeypatch):
    """``kernel_function`` loads the library and sets the entry point's
    ctypes signature at the first lookup only; later launches reuse it."""
    import ctypes

    loads = []

    def fake_load(name):
        loads.append(name)
        return kernels.KernelLibrary(ctypes.CDLL(None), None, 0.0, "")

    monkeypatch.setattr(kernels, "load_kernel_library", fake_load)
    monkeypatch.setattr(kernels, "_functions", {})
    fn = kernels.kernel_function("libc", "abs", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    fn.argtypes = [ctypes.c_long]  # a later change would survive: no reset
    assert kernels.kernel_function("libc", "abs", [ctypes.c_int]) is fn
    assert fn.argtypes == [ctypes.c_long] and loads == ["libc"]
    assert fn(-3) == 3
