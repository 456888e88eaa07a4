"""Mean host milliseconds of one render chunk over the traced frames: the
program's ngp.chunk span (one render_rays_ngp of chunk rays: march, field,
composite), start to end."""
from benchmark.lib import spans


def read(r):
    if r.mode != "render":
        return None
    found = spans.program_spans(r.trace, ("ngp.chunk",))
    return 1e3 * sum(spans.seconds(e) for e in found) / len(found) if found else None
