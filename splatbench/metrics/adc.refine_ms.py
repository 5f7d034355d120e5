"""The ADC refinement's host span `timings["adc_refine"]` (host seconds in
`training/trainer.py`'s ADC refinement: the candidate count, any growth of the pool, the
grow and prune, and the counts' readback; a part of `timings["hooks"]`) over the window's
ADC refinements, in ms a refinement. ADC train cells; None where the program keeps no such
span or the window held no refinement."""


def read(rec, cell):
    if rec["kind"] != "train" or not rec.get("adc_refines"):
        return None
    seconds = rec["timings"].get("adc_refine")
    return None if seconds is None else 1e3 * seconds / rec["adc_refines"]
