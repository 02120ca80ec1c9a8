"""scripts/sweep_mem_attention.py builds its variants by substituting the
kernel's pipeline constants in csrc/mem_attention.cu. A substitution that
matches nothing would leave a variant equal to the shipped kernel, so the
script stops instead; these tests hold both on the CPU (no nvcc needed),
and the ptxas-log reader, its fault check and the build log kept beside
each library, which the sweep and chip_smoke.py share."""

import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sweep(name="sweep_mem_attention"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(name="mem_attention.cu"):
    with open(os.path.join(REPO, "dgvcc_tpu_torch", "csrc", name)) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(_sweep().VARIANTS))
def test_every_variant_sets_every_constant(name):
    sweep = _sweep()
    params = sweep.VARIANTS[name]
    text = sweep.variant_source(_source(), params)
    for (const, pattern), value in zip(sweep.CONSTANTS.items(), params):
        found = re.findall(pattern, text)
        assert len(found) == 1, const
        assert found[0].endswith(f"= {value};"), (const, found[0])


def test_a_constant_the_kernel_lacks_stops_the_sweep():
    sweep = _sweep()
    src = _source().replace("constexpr int kStages", "constexpr int kRingDepth")
    with pytest.raises(SystemExit, match="kStages matched 0 times"):
        sweep.variant_source(src, next(iter(sweep.VARIANTS.values())))


def test_ptxas_report_keeps_the_kernel_lines_and_its_serialisation_warning():
    """ptxas prints C7512 ('wgmma ... serialized') before the function's own
    lines; the report keeps it with the function's spills and registers."""
    from dgvcc_tpu_torch.ops import _build

    log = "\n".join([
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
        "are serialized due to insufficient register resources for the function "
        "'_Z25mem_attention_bf16_kernelILi256EEv'",
        "ptxas info    : Compiling entry function '_Z24mem_attention_f32_kernelILi256EEv' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z25mem_attention_bf16_kernelILi256EEv' "
        "for 'sm_90a'",
        "    224 bytes stack frame, 264 bytes spill stores, 256 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers"])
    report = _build.ptxas_report(log, "mem_attention_bf16_kernelILi256E")
    assert len(report) == 3
    assert report[0].startswith("(C7512)")
    assert report[1].startswith("224 bytes stack frame")
    assert report[2] == "Used 168 registers, used 16 barriers"
    assert _build.ptxas_report(log, "mem_attention_f32_kernelILi256E") == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 96 registers, used 1 barriers"]


@pytest.mark.parametrize("name", sorted(_sweep("sweep_mem_attention_train").VARIANTS))
def test_every_training_forward_variant_sets_every_constant(name):
    """scripts/sweep_mem_attention_train.py: the same rule for kernel #2's
    constants in csrc/mem_attention_train.cu."""
    sweep = _sweep("sweep_mem_attention_train")
    params = sweep.VARIANTS[name]
    text = sweep.variant_source(_source("mem_attention_train.cu"), params)
    for const, value in zip(sweep.CONSTANTS, params):
        found = re.findall(rf"constexpr int {const} = \d+;", text)
        assert found == [f"constexpr int {const} = {value};"], const


CLEAN = ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
         "Used 168 registers, used 16 barriers"]


@pytest.mark.parametrize("report,n_faults", [
    (CLEAN, 0),
    (["(C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized"]
     + CLEAN, 1),
    (["(C7514) Potential Performance Loss: wgmma.mma_async instructions are serialized due "
      "to non wgmma instructions reading accumulator registers"] + CLEAN, 1),
    (["224 bytes stack frame, 264 bytes spill stores, 256 bytes spill loads", CLEAN[1]], 1),
    (["0 bytes stack frame, 0 bytes spill stores, 8 bytes spill loads", CLEAN[1]], 1),
    ([], 1),
], ids=["clean", "c7512", "c7514", "spill", "spill_loads_only", "empty"])
def test_ptxas_faults_flags_serialised_wgmma_spills_and_a_missing_report(report, n_faults):
    from dgvcc_tpu_torch.ops import _build

    assert len(_build.ptxas_faults(report)) == n_faults


def _fake_nvcc(tmp_path, rc):
    """An nvcc stand-in: prints a ptxas report, writes its -o file, exits rc."""
    import sys

    path = tmp_path / "nvcc"
    path.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "print(\"ptxas info    : Compiling entry function '_Z1kILi256EEv' for 'sm_90a'\")\n"
        "print('    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads')\n"
        f"open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\nsys.exit({rc})\n")
    path.chmod(0o755)
    return str(path)


def _isolated_build(monkeypatch, tmp_path, rc):
    from dgvcc_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a source\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {"k": csrc / "k.cu"})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path, rc))
    return _build


def test_build_log_outlives_the_build(monkeypatch, tmp_path):
    """The ptxas report of a library that is up to date (nothing rebuilt)
    is still read back from the log kept beside it."""
    _build = _isolated_build(monkeypatch, tmp_path, 0)
    logs = _build.build_all(["k"])
    assert _build.library_path("k").exists()
    assert _build.build_log("k") == logs["k"]
    assert _build.build_all(["k"]) == {}  # up to date: not rebuilt
    assert _build.ptxas_report(_build.build_log("k"), "kILi256E") == [CLEAN[0]]


def test_a_failed_build_raises_and_keeps_no_library_or_log(monkeypatch, tmp_path):
    _build = _isolated_build(monkeypatch, tmp_path, 1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["k"])
    assert not _build.library_path("k").exists()
    assert _build.build_log("k") == ""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# cuobjdump -sass of a library that holds a wgmma kernel fed by TMA and an
# mma.sync kernel of the same family (abridged: one line per op)
SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_117mat_bwd_rows_bf16ILi256EEEv14CUtensorMap_stS1_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0100*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;
        /*0210*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR16], R24 ;
        /*0300*/                   UTMASTG.2D [UR4], [UR6] ;
		..........

		Function : _ZN12_GLOBAL__N_112mat_fwd_bf16ILi256EEEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
		..........

		Function : _ZN12_GLOBAL__N_117mat_bwd_cols_bf16ILi256EEEv14CUtensorMap_stS1_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0100*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0200*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
		..........
"""


def test_sass_counts_are_taken_body_by_body():
    """chip_smoke.py reads cuobjdump's SASS per function body: the forward's
    mma.sync (HMMA) in the same library counts against no other kernel."""
    cs = _chip_smoke()
    rows = cs.sass_counts(SASS, "mat_bwd_rows_bf16")
    assert list(rows) == ["_ZN12_GLOBAL__N_117mat_bwd_rows_bf16ILi256EEEv14CUtensorMap_stS1_"]
    assert next(iter(rows.values())) == {"HGMMA": 2, "UTMALDG": 1, "UTMASTG": 1, "HMMA": 0}
    assert cs.wgmma_tma_faults(rows, 1) == []
    both = cs.sass_counts(SASS, "mat_bwd_(rows|cols)_bf16")
    assert len(both) == 2
    faults = cs.wgmma_tma_faults(both, 2)
    assert len(faults) == 1 and "mat_bwd_cols_bf16" in faults[0]
    assert cs.wgmma_tma_faults(rows, 2) == ["1 function bodies, expected 2"]
    assert cs.sass_counts(SASS, "mat_fwd_bf16")[
        "_ZN12_GLOBAL__N_112mat_fwd_bf16ILi256EEEvPK13__nv_bfloat16"]["HMMA"] == 1
