"""Router entry point::

    python -m generativeaiexamples_tpu_torch.router --port 9000 \\
        --replica http://127.0.0.1:8081 --replica http://127.0.0.1:8082

``--replica`` flags override the ``router.replicas`` config list
(``APP_ROUTER_REPLICAS``); ``--policy`` overrides ``router.policy``. The
router is host-only: it never touches the card.
"""
from __future__ import annotations

import argparse
import dataclasses

from generativeaiexamples_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Cache-aware multi-replica routing tier"
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument(
        "--replica", action="append", default=[],
        help="replica base URL (repeatable; overrides router.replicas)",
    )
    parser.add_argument(
        "--policy", default="", choices=("", "affinity", "round_robin"),
        help="placement policy override",
    )
    args = parser.parse_args()

    from generativeaiexamples_tpu_torch.config import get_config
    from generativeaiexamples_tpu_torch.router.app import create_router

    config = get_config()
    if args.policy:
        config = dataclasses.replace(
            config, router=dataclasses.replace(config.router, policy=args.policy))
    router = create_router(config, replica_urls=args.replica or None)
    server = router.build_server(args.host, args.port)
    logger.info("router on %s:%d over %s", args.host, args.port, router.replicas)
    try:
        server.serve_forever()
    finally:
        router.stop()
        server.server_close()


if __name__ == "__main__":
    main()
