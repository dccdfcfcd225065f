"""FLOPs of the window's calls, as counted on the plain reference
(``counts/flops.py``), over the window's time and the cards' dense
tensor-core peak in the configuration's compute dtype (H100 SXM data
sheet, a card: bf16 989 TFLOP/s; TF32 494.7 for float32, whose
convolutions cuDNN runs in TF32)."""

UNIT = "%"


def read(r):
    return 100.0 * r.flops_per_call * r.calls / r.seconds / (
        r.chips * r.peak_flops)
