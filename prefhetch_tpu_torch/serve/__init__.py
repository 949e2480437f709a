"""Serving: route dispatch (handlers.py), the cross-request batcher, the
threaded, asyncio and native epoll HTTP frontends, and the entry point."""
