"""Acoustic forwards a synthesize call in the window: a forward hook the
benchmark registers on the model, over the calls (1 when the frame estimate
holds, 2 when a call re-runs at the exact bucket)."""

UNIT = "count"
SOURCE = "program_counter"
MOVES = "synth_audio_s_per_s"


def read(r):
    calls = r.counters.get("calls")
    return r.counters["forwards"] / calls if calls else None
