"""predict_setup_s: the setup_* phases of MAGI_v2.predict_timings (the
facade's sampling setup: operators, GN factor, target), mean per call."""


def read(run):
    calls = run.timed_calls()
    if not calls:
        return None
    per = [sum(v for k, v in c.predict_timings.items()
               if k.startswith("setup_")) for c in calls]
    return sum(per) / len(per)
