"""Where a request enters the program, one module an entry:
``entries/<entry>.py``, found by the traffic mix's ``entry`` key
(``cell.load``). It holds ``Entry(system)``, whose ``handle(method, path,
headers, body) -> (status, content type, body)`` the traffic drives, and
``close()``, which stops whatever the entry started.
"""
