"""``"dispatcher"``: the program's ``Dispatcher.handle`` in process, called
on the client's own thread, bytes in and bytes out (sut.py)."""


class Entry:
    def __init__(self, system):
        self.handle = system.handle

    def close(self) -> None:
        self.handle = None
