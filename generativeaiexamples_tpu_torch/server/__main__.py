"""Chain-server entry point::

    python -m generativeaiexamples_tpu_torch.server --port 8081

``EXAMPLE_NAME`` picks the chain (``developer_rag``, the default, or
``echo``) and the JAX config's ``APP_*`` variables the engines
(``APP_LLM_MODELENGINE``, ``APP_EMBEDDINGS_MODELENGINE``,
``APP_RANKING_MODELENGINE``, ...), over the JSON or YAML file that
``APP_CONFIG_FILE`` names; ``--help-config`` prints the schema. Models and
stores run on the card; ``--device cpu`` runs their plain PyTorch paths on
the CPU instead.
"""
import argparse
import logging
import os
import sys

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.server.api import make_server
from generativeaiexamples_tpu_torch.utils.logging import configure_root

logger = logging.getLogger(__name__)


def main() -> None:
    parser = argparse.ArgumentParser(description="Chain server of the PyTorch port")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=int(os.environ.get("APP_SERVERPORT", 8081)))
    parser.add_argument("--device", default=None,
                        help="device of the models and stores (default: the card)")
    parser.add_argument("--help-config", action="store_true",
                        help="print the config schema with APP_* env names and exit")
    args = parser.parse_args()
    if args.help_config:
        from generativeaiexamples_tpu_torch.config import AppConfig

        AppConfig.print_help(sys.stdout.write)
        return
    configure_root()
    runtime.set_device(args.device)
    server = make_server(args.host, args.port)
    logger.info("chain server on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
