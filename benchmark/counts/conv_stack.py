"""K5, the fused 8-layer cylindrical conv stack (``csrc/conv_stack.cu``),
"sampled" descriptor with ``fused_conv``: a launch a scale for every 6000
patches (the descriptor net's sub-batches). Reads x [k, 3, 7, 20, 16] f32,
the folded weights [5328, 128] bf16 and bias [8, 128] f32, writes
[k, 7, 20, 32] f32; 2 * 7 * 20 * 9 * sum(ci * co) operations a patch in
bf16 on the tensor cores."""

from __future__ import annotations

from benchmark.roofline import PEAK_BF16_PER_S

KERNEL = r"\bconv_stack_kernel\b"
LAYER_CHANNELS = ((48, 64), (64, 64), (64, 128), (128, 128),
                  (128, 64), (64, 64), (64, 32), (32, 32))
CHUNK = 6000


def launch(patches: int) -> tuple:
    macs = sum(ci * co for ci, co in LAYER_CHANNELS)
    return (patches * 3 * 7 * 20 * 16 * 4 + 5328 * 128 * 2 + 8 * 128 * 4
            + patches * 7 * 20 * 32 * 4,
            2.0 * patches * 7 * 20 * 9 * macs, PEAK_BF16_PER_S)


def applies(statics: dict) -> bool:
    return (statics["desc_mode"] == "sampled" and statics["fused_conv"]
            and (statics["rad_n"], statics["ele_n"], statics["azi_n"])
            == (3, 7, 20) and statics["use_bf16"]
            and statics["desc_width"] == 1.0)


def launches(statics: dict, passes: list) -> list:
    if not applies(statics):
        return []
    out = []
    for b, scales in passes:
        k = 2 * b * statics["num_fps"]
        for _s in scales:
            out += [launch(min(CHUNK, k - i)) for i in range(0, k, CHUNK)]
    return out
