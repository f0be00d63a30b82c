"""``repro_torch.kernels.report`` reads ptxas reports and ``cuobjdump -sass``
listings; phase B of ``chip_smoke.py`` gates the bf16 flash builds on what it
reads (no spill, USETMAXREG beside HGMMA, no serialised wgmma) and the fp32
ones (no spill, HGMMA). Here it reads text shaped as the tools print it."""
from repro_torch.kernels import report
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FA128 = "_ZN12_GLOBAL__N_19fa_fwd_tcILi128ELi128EEEvNS_4ArgsE"
FA192 = "_ZN12_GLOBAL__N_19fa_fwd_tcILi192ELi128EEEvNS_4ArgsE"
GEMM = "_ZN12_GLOBAL__N_111gemm_kernelILb1ELb0EEEvPKfS2_Pfiiii"
TF32 = "_ZN12_GLOBAL__N_118fa_fwd_tf32_kernelILi192ELi128EEEvNS_4ArgsE"

PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FA128}' for 'sm_90a'
ptxas info    : Function properties for {FA128}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '{FA192}' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the wgmma pipeline in the function '{FA192}'
ptxas info    : Function properties for {FA192}
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '{GEMM}' for 'sm_90a'
ptxas info    : Used 154 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '{TF32}' for 'sm_90a'
ptxas info    : Function properties for {TF32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 400 bytes cmem[0]
"""

SASS = f"""
	code for sm_90a
		Function : {FA128}
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   USETMAXREG.DEALLOC.CTAPOOL 0x18 ;
        /*0010*/                   USETMAXREG.TRYALLOC.CTAPOOL 0xf0 ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R88, gdesc[UR4], RZ, !UPT ;
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, R120, gdesc[UR8], R24 ;
        /*0040*/                   FADD R200, R3, R7 ;
		Function : {GEMM}
        /*0000*/                   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], RZ, !UPT ;
		Function : {TF32}
        /*0000*/                   USETMAXREG.DEALLOC.CTAPOOL 0x60 ;
        /*0010*/                   HGMMA.64x64x8.F32.TF32 R40, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x32x8.F32.TF32 R24, R120, gdesc[UR8], R24 ;
"""


def test_template_args_reads_integers_and_bools():
    assert report.template_args(FA192) == ["192", "128"]
    assert report.template_args(GEMM) == ["1", "0"]


def test_ptxas_lines_keys_each_instantiation():
    lines = report.ptxas_lines(PTXAS, "fa_fwd_tc", "hd")
    assert set(lines) == {"hd128_128", "hd192_128"}
    assert "0 bytes spill stores" in lines["hd128_128"] and "Used 168" in lines["hd128_128"]
    gemm = report.ptxas_lines(PTXAS, "gemm_kernel", "ab")
    assert list(gemm) == ["ab1_0"] and "Used 154 registers" in gemm["ab1_0"]


def test_wgmma_serialized_names_the_function():
    lines = report.wgmma_serialized(PTXAS)
    assert len(lines) == 1 and FA192 in lines[0]


def test_parse_sass_names_kernels_by_kind_and_template_args():
    sass = report.parse_sass(SASS)
    assert set(sass) == {"fa_fwd_tc_128_128", "gemm_kernel_1_0", "fa_fwd_tf32_kernel_192_128"}
    assert sum("HGMMA" in ln for ln in sass["gemm_kernel_1_0"]) == 1


def test_bf16_flash_design_reads_registers_spills_and_opcodes():
    design = report.flash_design(PTXAS, report.parse_sass(SASS), "fa_fwd_tc")
    assert design["hd128_128"] == {"registers": 168, "spill_stores": 0, "spill_loads": 0,
                                   "hgmma": 2, "usetmaxreg": 2,
                                   # R24 of an m64n128 accumulator spans R24..R87
                                   "sass_max_register": 200}
    # a build missing from the SASS reads no instructions, and its spills show
    assert design["hd192_128"]["spill_stores"] == 12
    assert design["hd192_128"]["spill_loads"] == 16
    assert design["hd192_128"]["hgmma"] == design["hd192_128"]["usetmaxreg"] == 0


def test_flash_design_reads_the_fp32_kernel_by_its_pairs():
    """The fp32 kernel's builds are keyed by (hd, hdv) as the bf16 kernel's."""
    design = report.flash_design(PTXAS, report.parse_sass(SASS), "fa_fwd_tf32_kernel")
    assert design == {"hd192_128": {"registers": 168, "spill_stores": 0, "spill_loads": 0,
                                    "hgmma": 2, "usetmaxreg": 1,
                                    # R40 of an m64n64 accumulator spans R40..R71
                                    "sass_max_register": 120}}
