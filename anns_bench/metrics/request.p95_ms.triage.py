"""The 95th percentile (nearest rank) of search-b64's request latency, from
send to full answer, in the traced run: every request of the window but
those that overlap the profiler's slice, which slows them. Host speed
moves it by more than an end-to-end bound can hold, so it stands here
beside qps."""

from anns_bench.stats import percentile


def read(run):
    span = (run.device or {}).get("span")
    lat = [(r.t_done - r.t_send) * 1e3 for r in run.reqs
           if not span or r.t_done < span[0] or r.t_send > span[1]]
    return percentile(lat, 95) if lat else None
