"""Whole predict's share of the card's dense peak: images served x deploy
FLOPs an image (the configuration's count, 2 a multiply-add of every conv)
over the window's seconds x the peak of the precision (bf16 989 TFLOP/s,
int8 1979 TOP/s), in %."""
from portbench import yardstick as Y


def read(rec):
    if "images" not in rec or "precision" not in rec:
        return None
    flops = rec["images"] * rec["config"]["deploy_flops_per_image"]
    return 100.0 * flops / (rec["window_s"] * Y.PEAK[rec["precision"]])
