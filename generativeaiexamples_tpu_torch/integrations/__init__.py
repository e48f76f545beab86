"""Framework connectors of the port (the root ``integrations/`` package's
counterparts, with its class names).

Adapters that expose the port's in-process engine and encoder on the card,
or any OpenAI-compatible endpoint (``generativeaiexamples_tpu_torch.engine.
server``), to LangChain (``langchain``), LlamaIndex (``llamaindex``) and
PandasAI (``pandasai``). The frameworks are optional: every adapter works
standalone with the same method surface, and each ``as_langchain()`` /
``as_llamaindex()`` imports its framework only when called.
"""
