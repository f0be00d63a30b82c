"""What ptxas and the SASS say of the kernel libraries that ``build`` makes:
registers and spills per instantiation, and instructions by opcode.

``chip_smoke.py`` gates its kernels on these readings and
``tools/flash_hd128_variants.py`` prints them per variant. The SASS is read
with ``cuobjdump`` (the CUDA toolkit's, else the copy in Triton's package),
so those functions run only where the kernels are built.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path


def template_args(mangled):
    """The integer and bool template arguments in a mangled kernel name
    (``ILi64E``: 64; ``ILb1ELb0E``: 1, 0)."""
    return re.findall(r"L[ib](\d+)E", mangled)


def ptxas_lines(report, marker, prefix, key=None):
    """Registers, stack and spills of each function whose name holds
    ``marker``, from an ``nvcc -Xptxas -v`` report, keyed by ``prefix`` and
    the template arguments in its mangled name (``hd`` and ``ILi64E``:
    hd64), or by ``key(mangled name)``."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if marker in m.group(1) else None
            continue
        if name is None:
            continue
        k = key(name) if key else prefix + "_".join(template_args(name))
        if "spill" in line or "Used" in line:
            out[k] = (out.get(k, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def wgmma_serialized(report):
    """The lines of an ``nvcc -Xptxas -v`` report where ptxas says it
    serialised a function's wgmma (each waits for the one before), which
    undoes the overlap of products with other work."""
    return [line.strip() for line in report.splitlines()
            if "wgmma" in line and "serializ" in line]


def sass_functions(library):
    """{kernel: its SASS lines} of a built library; a kernel is named by its
    kind and template arguments (``fa_fwd_tc_128_128``)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        import triton
        tool = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    return parse_sass(sass)


def parse_sass(sass):
    """{kernel: its lines} of ``cuobjdump -sass`` output."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kind = re.search(r"fa_fwd_tc|fa_fwd_tf32_kernel|gemm_kernel", m.group(1))
            args = template_args(m.group(1))
            name = (kind.group(0) + "".join(f"_{a}" for a in args)) if kind else m.group(1)
            out[name] = []
        elif name:
            out[name].append(line)
    return out


def sass_counts(library, opcode="HGMMA"):
    """Instructions of one opcode (HGMMA, USETMAXREG, ...) in the SASS of
    each kernel of a built library."""
    return {name: sum(opcode in line for line in lines)
            for name, lines in sass_functions(library).items()}


def flash_design(report, sass, kernel):
    """Per build of a flash kernel (``fa_fwd_tc``, bf16; ``fa_fwd_tf32_kernel``,
    fp32; ptxas key ``hd<hd>_<hdv>``): registers and spill bytes from the
    ptxas ``report``, and the HGMMA and USETMAXREG instructions in its SASS
    (``sass``: ``sass_functions`` of the library)."""
    out = {}
    for key, line in ptxas_lines(report, kernel, "hd").items():
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        code = sass.get(f"{kernel}_" + key[2:], [])
        named = [int(r) for ln in code for r in re.findall(r"\bR(\d+)\b", ln)]
        # an HGMMA names the first register of its accumulator's N / 2
        for ln in code:
            m = re.search(r"HGMMA\.64x(\d+)x\d+\.F32\S* R(\d+)", ln)
            if m:
                named.append(int(m.group(2)) + int(m.group(1)) // 2 - 1)
        out[key] = {"registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "spill_loads": int(spill.group(2)) if spill else None,
                    "hgmma": sum("HGMMA" in ln for ln in code),
                    "usetmaxreg": sum("USETMAXREG" in ln for ln in code),
                    # the highest register the code names: above the launch's
                    # share, the consumers run on what setmaxnreg gave them
                    "sass_max_register": max(named, default=None)}
    return out
