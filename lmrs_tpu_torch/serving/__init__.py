"""HTTP serving front end of the port: the OpenAI- and Anthropic-wire
server over an engine (``server.py``), the router over a pool of such
servers (``router.py``) and ``lmrs-serve-torch`` (``cli.py``)."""

from lmrs_tpu_torch.serving.server import EngineHTTPServer, serve

__all__ = ["EngineHTTPServer", "serve"]
