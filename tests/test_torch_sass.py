"""The SASS counter of fastsmc_tpu_torch.probes.sass on a hand-written
dump in both forms cuobjdump gives branch targets (an address, or a label
line), and its reading of ptxas' log. The dump itself needs the CUDA
toolkit and is read on the card by ``python -m
fastsmc_tpu_torch.probes.sass`` and chip_smoke.py's A/B."""

import pytest

from fastsmc_tpu_torch.probes.sass import parse_sass, ptxas_lines

NAME = "_ZN7fastsmc3bwd19hmm_backward_kernelILi9ELi2ELb0ELb0ELb0EEEvPKf"
DUMP = f"""
	code for sm_90a
		Function : {NAME}
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
.L_x_3:
        /*0030*/                   LDS.128 R4, [R2] ;
        /*0040*/                   LDS R8, [R3] ;
        /*0050*/                   LDS.64 R10, [R3+0x80] ;
        /*0060*/                   FFMA R9, R4, R8, R9 ;
        /*0070*/                   FFMA R12, R5, R8, R12 ;
        /*0080*/              @!P0 BRA `(.L_x_3) ;
        /*0090*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*00a0*/                   FFMA R9, R4, R8, R9 ;
        /*00b0*/                   BRA 0x10 ;
        /*00c0*/                   EXIT ;
		Function : other_kernel
        /*0000*/                   EXIT ;
"""


def test_counts_whole_function_and_densest_loop():
    got = parse_sass(DUMP)
    assert set(got) == {NAME, "other_kernel"}
    total, loop = got[NAME]["total"], got[NAME]["densest_loop"]
    assert total == {"FFMA": 3, "HMMA": 0, "HGMMA": 0, "LDS": 1, "LDS.64": 1,
                     "LDS.128": 1, "LDSM": 0, "SHFL": 0, "LDG": 1, "BAR": 1,
                     "SYNCS": 1, "LDL": 0, "STL": 0, "instructions": 13}
    # the loop at .L_x_3 (6 instructions, 2 FFMA) is denser than the one
    # back to 0x10 (11 instructions, 3 FFMA)
    assert loop == {"FFMA": 2, "HMMA": 0, "HGMMA": 0, "LDS": 1, "LDS.64": 1,
                    "LDS.128": 1, "LDSM": 0, "SHFL": 0, "LDG": 0, "BAR": 0,
                    "SYNCS": 0, "LDL": 0, "STL": 0, "instructions": 6}
    assert got["other_kernel"]["densest_loop"] is None


FWD = "_ZN7fastsmc12_GLOBAL__N_118hmm_forward_kernelILi9ELb0ELb0EEEvPKfS3_i"
# a tensor-core function: the densest loop is found by its HMMA share, so
# the short FFMA-only loop at .L_x_1 loses to the product loop at .L_x_2;
# a register spilled before the loops (STL) is reloaded in it (LDL)
FWD_DUMP = f"""
		Function : {FWD}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0008*/                   STL [R1+0x4], R2 ;
.L_x_1:
        /*0010*/                   FFMA R2, R3, R4, R2 ;
        /*0020*/                   FFMA R5, R3, R4, R5 ;
        /*0030*/                   BRA `(.L_x_1) ;
.L_x_2:
        /*0040*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0050*/                   LDS.64 R8, [R2] ;
        /*0060*/                   LDSM.16.M88.4 R12, [R2+0x100] ;
        /*0070*/                   HMMA.1684.F32.TF32 R16, R4, R8, R16 ;
        /*0080*/                   HMMA.16816.F32.BF16 R20, R4, R12, R20 ;
        /*0088*/                   LDL R26, [R1+0x4] ;
        /*0090*/                   FMUL R24, R16, R17 ;
        /*00a0*/                   SHFL.BFLY PT, R25, R24, 0x1, 0x1f ;
        /*00b0*/              @!P0 BRA `(.L_x_2) ;
        /*00c0*/                   EXIT ;
"""


def test_densest_loop_by_hmma_share_where_there_are_tensor_cores():
    got = parse_sass(FWD_DUMP)[FWD]
    assert got["total"] == {"FFMA": 2, "HMMA": 2, "HGMMA": 0, "LDS": 0,
                            "LDS.64": 1,
                            "LDS.128": 0, "LDSM": 1, "SHFL": 1, "LDG": 0,
                            "BAR": 0, "SYNCS": 1, "LDL": 1, "STL": 1,
                            "instructions": 15}
    assert got["densest_loop"] == {"FFMA": 0, "HMMA": 2, "HGMMA": 0, "LDS": 0,
                                   "LDS.64": 1, "LDS.128": 0, "LDSM": 1,
                                   "SHFL": 1, "LDG": 0, "BAR": 0,
                                   "SYNCS": 1, "LDL": 1, "STL": 0,
                                   "instructions": 9}


# the probe's two wgmma kernels, as nvcc mangles them
WG = ("_ZN7fastsmc12_GLOBAL__N_126alpha_wall_backward_kernelILb1ELb0EEEv",
      "_ZN7fastsmc12_GLOBAL__N_125alpha_wall_forward_kernelILb1ELb0EEEv")
# a wgmma function: HGMMA is the product's opcode, so the loop at .L_x_5
# (two HGMMA in 6 instructions) wins over the FFMA loop at .L_x_4
WG_DUMP = """
		Function : {name}
.L_x_4:
        /*0000*/                   FFMA R2, R3, R4, R2 ;
        /*0010*/                   BRA `(.L_x_4) ;
.L_x_5:
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0030*/                   WARPGROUP.ARRIVE ;
        /*0040*/                   HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR8], RZ ;
        /*0050*/                   HGMMA.64x128x16.F32.BF16 R24, R156, gdesc[UR12], R24 ;
        /*0060*/                   FMUL R8, R24, R25 ;
        /*0070*/              @!P0 BRA `(.L_x_5) ;
        /*0080*/                   EXIT ;
"""


@pytest.mark.parametrize("name", WG, ids=("backward", "forward"))
def test_densest_loop_by_hgmma_share_where_there_is_wgmma(name):
    got = parse_sass(WG_DUMP.format(name=name))[name]
    assert got["total"]["HGMMA"] == 2 and got["total"]["FFMA"] == 1
    loop = got["densest_loop"]
    assert loop["HGMMA"] == 2 and loop["FFMA"] == 0
    assert loop["HMMA"] == 0 and loop["instructions"] == 6


def test_ptxas_lines():
    log = (f"ptxas info    : Compiling entry function '{NAME}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 32 bytes "
           "smem\n")
    got = ptxas_lines(log)
    assert list(got) == [NAME]
    assert "0 bytes spill stores" in got[NAME]
    assert "Used 128 registers" in got[NAME]
