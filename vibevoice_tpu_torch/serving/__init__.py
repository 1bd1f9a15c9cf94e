from .server import BatchingFrontend, TTSServer, serve  # noqa: F401
