"""Host time in the program's ``engine.pack`` spans (a bucket's pictures
packed into its staging buffer) a call, over the calls that started in
the window: from the spans the system recorded (``run.program``, traced
runs only). None where the program records no such span."""


def read(run):
    program = getattr(run, "program", None)
    if not program:
        return None
    calls = {p.id for p in program
             if p.name == "engine.call" and run.t0 <= p.start_ns / 1e9 < run.t1}
    packs = [p for p in program if p.name == "engine.pack" and p.call in calls]
    if not calls or not packs:
        return None
    return sum(p.end_ns - p.start_ns for p in packs) / 1e6 / len(calls)
