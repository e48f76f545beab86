"""Frontend entry point::

    python -m generativeaiexamples_tpu_torch.frontend --port 8090 \\
        --chain-server http://localhost:8081

Point ``--chain-server`` at a chain server or at the router in front of
a fleet of them.
"""
from __future__ import annotations

import argparse

from generativeaiexamples_tpu_torch.frontend.api import FrontendServer
from generativeaiexamples_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="RAG playground frontend")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument(
        "--chain-server",
        default="",
        help="chain-server base URL (default: APP_SERVERURL[:APP_SERVERPORT])",
    )
    args = parser.parse_args()
    frontend = FrontendServer(args.chain_server)
    server = frontend.build_server(args.host, args.port)
    logger.info(
        "frontend on http://%s:%d -> chain-server %s",
        args.host,
        args.port,
        frontend.chain_server_url,
    )
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
