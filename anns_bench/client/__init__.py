"""Frozen copies of the client side of each protocol the traffic speaks.

numpy and the standard library only: nothing here imports the program, so
work cannot move from the served path into an unmeasured client.
"""
