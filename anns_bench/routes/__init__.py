"""Request kinds, one module a route: ``routes/<route>.py``, found by the
traffic mix's ``route`` key (``cell.load``).

A route module holds:

- ``Route``: a subclass of ``traffic.Traffic`` with the route's bodies,
  items, one request and the decoding of an answer (traffic.py's class
  docstring names the methods);
- ``judge(ref, queries, qidx, ids, dist, failed, k) -> (numbers,
  recall)``: the comparison its answers are held to (judge.py, or a judge
  of the route's own);
- ``answered(mix, n_pool)``: the pool rows a run's window answers;
- ``control(ref, queries, config) -> (ids, dist)``: what the reference
  computed a precision lower answers for those rows, in the route's
  answer form (control.py).

Its client, the frozen client side of its wire, comes from
``anns_bench/client/``.
"""
