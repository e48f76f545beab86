"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each one's failure makes the script exit non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the serving path from ``csrc/`` (five
   files, one nvcc each, all started together);
3. each kernel against its plain PyTorch version at the serving path's
   shapes for llama3-8b, with its time, the plain version's, one library
   call's as a yardstick, and its bound: int8_matmul and int8_w8a8_matmul
   at the four projections and the lm_head (M = 1, 8 and the spec
   verify's 72; int8_matmul also at M = 4 and 16, untimed;
   int8_w8a8_matmul also at M = 16 and 128 and with f32 x, timed),
   paged_attention over bf16, int8 and int4 pools (ragged, uniform, short
   and split-edge rows, and the verify's T = 9, 5, 3 and 2 query rows a
   slot),
   flash_attention_causal at (2, 512) and (2, 300), decode_attention over
   the fixed layout's int8 cache (ragged, uniform, short and split-edge
   slots); each kernel again on the local tiles of phase 16's and 18's
   shards (``--checks tp``): int8_matmul and int8_w8a8_matmul at M = 8
   and at the spec verify's M = 72 on llama3-8b TP=2's column and row
   tiles (wq 4096->2048, wk/wv 4096->512, wo 2048->4096, w_gate/w_up
   4096->7168, w_down 7168->4096, lm_head 4096->64128), int8_matmul at M =
   8 on llama3-70b TP=8's (wq 8192->1024, w_gate 8192->3584, w_down
   3584->8192), paged_attention at 16/4 and 8/1 heads on all three pools
   and at the verify's T = 9 query rows a slot on 16/4 heads,
   decode_attention at 16/4 and flash at 16/4 (T = 512), each timed with
   its plain version, a library call and its bound;
   then ``sample_tokens`` (no kernel of the port) at 8 and 72
   seeded nucleus rows x 128,256, timed with each way of ranking the
   nucleus, the int64-key top-k's order held to a stable sort's;
4. model level at full llama3-8b width and depth (int8 packs, random from
   a seed), for each paged serving recipe (int8 weights + bf16 KV, w8a8 +
   int8 KV, int8 weights + int4 KV) and for the fixed layout (int8 weights
   + int8 cache): one 512-token prefill and 8 decode steps on the kernel
   path and on the plain path, logits and greedy tokens compared; the
   fixed kernel path against the paged int8 kernel path;
5. serve: four engines at full llama3-8b width and depth, built one
   after another: A (int8 weights, bf16 KV), B (w8a8, int8 KV) and D
   (int8 weights, int8 KV, fixed layout) behind the OpenAI-compatible
   HTTP server with a few concurrent requests (chat streaming and not,
   completions, one prompt longer than ``prefill_chunk``), then 8
   concurrent ``generate_ids`` on each of A, B, C (int8 weights, int4 KV)
   and D. Every kernel's launch count is set to 0 just before each engine
   serves and read just after. Each engine also reports its device time
   and its kernel launches per decode step, and the synchronizing CUDA
   calls each thread made while it served (``torch.cuda.set_sync_debug_mode``):
   the dispatch thread must make none; the reader waits once per readback.
   Engine A is then held against a second engine on the same weights at
   ``decode_runahead`` 1 (the same streams, greedy and a seeded sampled
   row), and that engine, built with ``max_queued_requests`` =
   ``max_batch_size``, takes more concurrent HTTP requests than fit: some
   answer 429 with ``Retry-After`` and ``X-GenAI-Queue-Depth``, the rest
   200. First, a thread's wait on a CUDA event must release the GIL.

6. retrieval: arctic-embed-l (the embedder) and arctic-embed-m (the
   reranker) at full width on the card, random from ``--seed``: 4
   passages on the card (bf16) against the CPU's f32 plain path; 512
   passages of 32-512 ids through the batched path, then the synchronous
   one, held to each other (and 8 rows alone against their batch), with
   passages/s, tokens/s and the device time of a dispatch at (32, 512),
   (32, 128) and (1, 64) with its share of the bf16 peak; a 65,536 x
   1024 store searched exact and IVF (nlist 64, nprobe 16) for 8
   embed_query vectors, exact held against numpy, search times at rows 1
   and 8 and k 4 and 16, IVF recall; each query's top 16 reranked, the
   logits held against the CPU's; then engine A behind the HTTP server
   with this embedder: ``/v1/embeddings`` and ``/v1/models``, and while 8
   greedy requests decode, an ingest of 64 passages that must wait on the
   engine's ``ingest_window``, ungated embed_query calls, and no
   synchronizing call on the LLM dispatch thread.
7. rag: ``developer_rag`` end to end through the port's chain server
   (``server/api.py``) on an ephemeral port, everything built by the
   port's factories from the JAX config's ``APP_*`` names (``RAG_ENV``):
   engine A (llama3-8b, int8 weights, bf16 paged pool, ``max_batch_size``
   8, ``max_seq_len`` 8192, ``prefill_chunk`` 512) through ``create_llm``,
   phase 6's arctic-embed-l and arctic-embed-m (or the factories' own when
   phase 6 does not run), a store under a temporary ``persist_dir``,
   ``ranked_hybrid``. 16 seeded documents (13 .txt, 2 .md, 1 .pdf) over
   ``POST /documents`` and listed by ``GET /documents``; ``POST /search``
   with a sentence of each of 8 documents finds that document first, and
   its top 4 equal the port's runtime on the CPU in f32 (near-ties of the
   reranker exempt); 8 concurrent ``/generate`` over the knowledge base and
   one without stream to ``[DONE]``, none a no-context answer, each prompt
   the engine received holding its top hit, ``int8_matmul``,
   ``paged_attention`` and ``flash_attention_causal`` launched and no
   synchronizing call on the LLM dispatch thread; a second round traced for
   the device's idle share; ``DELETE /documents`` drops a document from the
   store and BM25; ``deadline_ms`` 1 answers 504. It prints ingest s a
   document, /search ms, TTFT with its retrieval ms, prompt ids, decode
   tokens/s and the idle share, and the prefix cache's hits and misses
   (the engine serves at the JAX default, ``prefix_cache_enable`` auto).
8. chains: the text chains through the port's chain server, each picked
   through the registry, on phase 7's deployment (its engine A, encoders
   and ``default`` collection; alone, it builds them and ingests phase 7's
   16 documents), every engine request sampling from one seed:
   ``simple_rag`` ingests the 16 documents into its own collection over
   ``POST /documents`` (2000-character chunks, store and BM25), ``/search``
   finds a document's sentence in that document first, and 4 concurrent
   ``/generate`` (each of sentences of 4 documents) answer 200 with no
   warning; ``multi_turn`` runs 4 concurrent conversations of 3 turns with
   the history in ``messages``, after which ``conv_store`` holds 24 chunks
   in the store and BM25 and each first question retrieves its "User
   previously responded with ..." memory; 2 concurrent
   ``query_decomposition`` answers make at least 3 engine requests each
   (the engine's ``requests_prefilled``); ``api_catalog`` answers one
   ``/generate`` through the in-process backend, then the same through
   ``RemoteLLMBackend`` and the port's engine server on engine A: the
   engine gets the same prompt ids and both streams are the same text.
   ``int8_matmul``, ``paged_attention`` and ``flash_attention_causal`` are
   launched and the LLM dispatch thread makes no synchronizing call. It
   prints TTFT (mean, max) and prompt ids by chain, engine requests an
   answer, the launches, the prefix cache's hits and misses and the
   phase's wall seconds.
9. prefix: the automatic prefix KV cache on recipes A (shared pool pages)
   and D (a store of int8 strips and one copy a hit), llama3-8b at full
   width, D at 8 of its 32 layers (for the script's time, since phase 14)
   and A too (since phase 20), random weights (seed 0), the engine defaults
   otherwise (``prefill_chunk`` 512, ``page_size`` 128,
   ``decode_runahead`` 4). The JAX bench's shared-prefix pass: one
   preamble of 4 chunks (2048 ids), 16 distinct questions of 128 ids, 16
   greedy tokens, one request at a time, through an engine with
   ``prefix_cache_enable`` off (the cold streams) and then, on the same
   weights, an engine at the default ``auto`` (the warm ones). Every warm
   stream equals its cold one; 1 miss and 15 hits; a warm request
   dispatches 1 prefill chunk where a cold one dispatches 5; D makes 16
   store copies (1 insert, 15 fetches), A none and maps 15 x 16 pages; on
   A the donor's pages hold the same bits after the 16 decodes and the
   pages in use are the entries'; 0 synchronizing calls on the dispatch
   thread; then one held wave of a warm row, a cold 1.5k-id row and a
   300-id row, each equal to its cold reference or parting from it only
   at a token whose top-1 margin is within ``LOGITS_TOL`` (printed). It
   prints cold and warm TTFT (p50, max), the chunks, hits, misses, tokens
   reused and the pool or store size.

10. filechains: the file chains through the port's chain server, each
   picked through the registry, on phase 7's deployment (kept up through
   phase 8; alone, it builds engine A and the encoders), before phase 9,
   every engine request sampling from phase 8's seed, a stdlib stub VLM
   (``APP_MULTIMODAL_VLM_URL``) answering the graph flow's four prompts
   by image: ``structured_data`` (``CSV_NAME=PdM_errors``) takes the
   Azure predictive-maintenance errors table's 3,919 rows over 100
   machines in two uploads and refuses a third of other columns with the
   JAX message; 4 questions, decoded greedily (the recording engine sets
   temperature 0 under the API's floor of 0.1), at ``max_tokens`` 64 make
   up to 3 code-generation completions each (random weights write no
   program, so each should end in the no-context message), and the
   engine's requests must equal the path the chain took; ``multimodal``
   ingests a 4-page PDF (prose, a 12 x 5 table with planted words, a chart
   and a photo JPEG), an image-only PDF (a rendered page) and a 3-slide
   PPTX with a chart: the chunks by type equal those the port's CPU path
   makes from the same files (a chart's engine-written explanation aside),
   the stub VLM's calls by kind are 3 detect, 2 table, 1 caption and a
   transcribe only when the template OCR reads nothing, one ``_explain``
   engine request a chart; ``/search`` for the planted words finds the
   table chunk (the ``hybrid`` pipeline: a random reranker's order is
   noise), ``/generate`` answers neither canned message, and ``DELETE``
   drops a document. ``int8_matmul``, ``paged_attention`` and
   ``flash_attention_causal`` are launched and the LLM dispatch thread
   makes no synchronizing call. It prints which optional modules the
   machine has and the OCR branch taken, per question the path,
   completions, prompt ids, prefill chunks and seconds, per file the
   ingest seconds split into parse, OCR, VLM, explain and embed, and the
   answers' TTFT.

11. drain: preemption and the scheduler at full llama3-8b width and depth
   (int8 packs at seed 0, ``max_batch_size`` 8, ``max_seq_len`` 8192,
   page 128, ``prefill_chunk`` 512, ``decode_block`` 8), after phase 10 on
   phase 7's deployment (alone, it builds it and ingests phase 7's
   corpus), which it then takes down:
   (c) ``retrieval.search:error@1`` degrades one ``/generate`` to a
   warnings frame and the LLM-only answer; ``api_catalog`` over an
   upstream stub in front of the engine server that answers 503 twice,
   then serves, answers after ``retry_max_attempts`` (3) attempts, and one
   that always fails opens the ``llm_remote`` breaker after
   ``breaker_failure_threshold`` (5) failures, after which a request
   fails fast; (d) with ``APP_RETRIEVER_BACKEND=tier`` 8 concurrent
   ``/search`` answer as the synchronous path did (byte for byte, or
   scores within ``SEARCH_SCORE_TOL`` with tie runs as sets: the tier's
   dispatches are padded to ``ann_max_batch`` rows, a single query's are
   not), in fewer ANN dispatches than queries; (a) for recipe A (bf16
   pool; the int4 pool's drain is phase 18's): 8 chat streams of 101-157 ids x 64 tokens
   through the engine server (4 greedy, 4 seeded at temperature 0.7,
   top_p 0.9), undisturbed, then again under the fault
   ``engine.dispatch:delay=0.05@1x0`` with ``POST /internal/drain`` once
   each has a token: every stream ends ``PREEMPTED`` with a snapshot id,
   ``/internal/snapshots`` lists the 8, each document is relayed into
   ``/internal/restore`` of a second engine (same config, its own weights
   from seed 0, the shared spool) and restores in mode ``restore``, its
   pages bitwise the payload's, its spooled tokens plus the continuation
   equal to the undisturbed stream, with no synchronizing call on the
   dispatch thread; (b) on recipe A's weights at ``max_batch_size`` 12,
   the same 8 requests alone and then with 4 prompts of 1.5-2k ids
   submitted while they decode, under ``unified`` and then ``disagg``:
   equal streams, one handoff a request, the pages handed equal to those
   funded, no recompute, no synchronizing call on either tier's thread.
   It prints the drain seconds, snapshot bytes a request, restore latency
   (p50, max), the continuation's ``paged_attention`` launches by pool
   dtype, the handoff counters, each policy's decode wall step with and
   without the long prompts, the retrieval tier's dispatches a wave and
   the phase wall.

12. spec: speculative decoding at full llama3-8b width, every recipe at
   8 of its 32 layers (A since phase 17, for the script's time; int8 packs
   at seed 0, shared by the recipes; ``max_batch_size`` 8,
   ``max_seq_len`` 8192, page 128, ``prefill_chunk`` 512, ``decode_block``
   8, ``spec_draft_len`` 8), after phase 9: one engine a recipe, its legs
   toggled at runtime (the JAX bench's ``_spec_decode_pass``). Recipe A
   runs ``off``, ``lookup``, ``lookup`` with the pipeline off and
   ``draft_target`` (a llama3-8b draft whose dense bf16 weights are the
   target's packs dequantized, so that it accepts), on the ``copy_heavy``
   ramp (512 ids) and the ``normal`` walk (768 ids, chunked); B, C and D
   run ``off`` and ``lookup`` on ``copy_heavy``. A leg is a set of
   concurrent greedy requests a prompt set (A: 6 of 48 tokens; B, C, D: 4
   of 64), then one seeded request (temperature 0.7, top_p 0.8, seed 1234,
   24 tokens). Every leg's streams equal the ``off`` leg's, or part from
   them only at a token whose top-1 margin is within ``LOGITS_TOL``;
   lookup accepts drafts on ``copy_heavy``; the draft-model leg dispatches
   the draft and ``draft_target`` accepts in every set (the random
   ``llama3-1b-proxy`` draft runs in phase 18, on TP=2 shards); the dispatch
   thread's only synchronizing calls are the spec read backs. It prints
   per recipe and leg the tokens a target dispatch, the acceptance rate,
   the draft-dispatch share, the wall step (the host clock over the
   decode of the greedy requests), the device step and idle share (the
   union of the device's events in torch.profiler's CUDA trace of that
   window, for each leg's first set but the 1b draft's; not measured
   where the trace lost port kernels; the phase fails if it exceeds the
   window's wall), TTFT, the launches and the shapes they ran at (the
   verify's query rows, the matmuls' M), A's ``off`` set again untraced
   (the trace's cost), and the provenance: the weights are random, so
   acceptance is not a calibrated draft's.

13. observe: the observability surface at full llama3-8b, recipe A, in
   a child process of this script (``--observe-child``: its profile starts
   from a fresh CUPTI state, where after the earlier phases' profiler
   sessions in one process whole captures came back without their
   kernels; its log lines relayed, its launches counted in the sum) (int8
   packs at seed 0, a fresh engine built with the dispatch timeline on
   and ``ENABLE_PROFILING`` set, ``developer_rag``'s LLM chain behind the
   chain server and the engine server, tracing into a JSONL file): 8
   ``/generate`` at concurrency 4, each with its own ``traceparent``;
   ``/metrics`` in both formats on both servers holds exactly the port
   registry's ``genai_`` families, the TTFT histogram's count equals the
   requests the engine finished, and an OpenMetrics exemplar's trace id is
   a sent ``traceparent`` found in the JSONL export; one request's
   ``/internal/requests/{id}`` holds JAX's chain from ``http_request`` to
   ``finish`` in order; ``/internal/timeline?format=perfetto`` parses as a
   Chrome trace with dispatch spans, and the four shares of the engine's
   active wall, recomputed from the served spans of the bubble's window,
   each equal to the served 4-digit share within its rounding; a profile
   through ``/internal/profile/start`` and ``/stop`` over 2 requests holds
   ``int8_matmul_mma``, a ``paged_`` kernel and ``flash_attention_kernel``
   on its device track and, kernel by kernel, as many events as the
   wrappers launched (captured again, up to 3 times, when CUPTI drops
   events), prints busy and wall ms (busy <= wall) and the idle share, and
   reads back through ``/internal/timeline?trace=``;
   ``genai_engine_mfu_ratio`` and ``genai_engine_hbm_bw_ratio`` lie in
   (0, 1.05]; the dispatch thread makes no synchronizing call; then the
   host cost: a second engine on the same weights with the flight
   recorder, the timeline, tracing and profiling off, 3 pairs of 8 greedy
   requests x 64 tokens in turns, the median wall step (the reader's
   decode time a block) of each and its spread; and 2 more batches on the
   observed engine with every instrument's entry point timed
   (``_HostCostMeter``): the instruments' host time per dispatch on the
   dispatch thread, per token on the reader, and both a block against the
   wall step. It prints the phase's wall time (a budget of 90 s).

14. route: two replicas of phase 7's deployment (``python -m
   generativeaiexamples_tpu_torch.server``, llama3-8b recipe A at full
   width, each loading a bf16 checkpoint of 8 of its 32 layers (since
   phase 20; ``APP_ENGINE_CHECKPOINTPATH``, random at seed 0, written by the
   phase), 8 slots, ``max_seq_len`` 8192,
   page 128, ``prefill_chunk`` 512, the prefix cache at ``auto``,
   arctic-embed-l/m; one snapshot spool) started together behind the
   port's router (its ``__main__``, tenant ``limited:rate=1,burst=1``,
   bounded-load spill off) and the frontend (its ``__main__``) pointed at
   the router; 40 GB must be free first. Requests sample at temperature
   and top_p 0.1, the chain server's floor, which is greedy here (the top
   token of a random llama3-8b holds more than a tenth of the mass).
   (a) 8 conversations x 3 turns at concurrency 4, 32 tokens a turn, each
   first message at least 1,100 ids: under ``affinity`` every turn of a
   conversation carries its ring owner's ``X-GenAI-Replica`` and both
   replicas own some; then ``POST /internal/policy`` ``round_robin`` and 8
   new conversations, one request at a time (so each conversation's turns
   alternate replicas); the replicas' prefix-cache hits, summed, are higher
   under affinity. (b) 4 of phase 7's documents through ``POST
   /documents`` at the router are listed by both replicas, and ``/search``
   at the router finds a document's sentence in it first. (c) 4 streams of
   64 tokens keyed to r0, undisturbed, then again with r0's own ``POST
   /internal/drain`` once each has a frame: every client stream equals its
   undisturbed text with no ``PREEMPTED`` frame, failovers{preempted}
   rises by 4 and the router's records hold 4 restore acks in mode
   ``restore``; r0 resumes. (d) tenant ``limited``'s second request within
   a second answers 429 with Retry-After and reaches no replica. (e) a
   chat through the frontend's ``/api/generate`` equals the router's own
   answer. (f) ``/internal/trace/{id}`` of a request with its own
   ``traceparent`` holds the router's hop and the replica's phases. (g) a
   profile through r0's ``/internal/profile/start|stop`` over 2 routed
   requests is ``complete`` kernel by kernel and holds ``int8_matmul_mma``,
   a ``paged_`` kernel and ``flash_attention_kernel`` (the replica's
   wrapper counts beside them). (h) r1 SIGKILLed under 2 streams: both
   client streams equal their undisturbed text, failovers{replica_died}
   rises, ``/internal/fleet`` marks r1 unhealthy and ``/generate`` answers
   on r0. It prints the replicas' start seconds and memory, TTFT through
   the router against straight to a replica, the router's proxy-overhead
   p95 against its SLO, the longest gap a client saw in a handover and
   the phase wall (a budget of 150 s). Every process it started is gone
   when it ends.

15. connect: the configuration file, the native store and the framework
   connectors at llama3-8b's full width, recipe A from a bf16 checkpoint
   of 8 of its 32 layers (``CUT_LAYERS``, written at seed 0 and named by
   the file's ``engine.checkpointPath``, since phase 21; random int8 packs
   at full depth before), with arctic-embed-l. (a) A camelCase JSON file
   of phase 7's deployment (the ``faiss`` store under a temporary
   ``persistDir``, the
   hybrid pipeline, ``topK`` 2) named by ``APP_CONFIG_FILE``, with
   ``APP_RETRIEVER_TOPK=3`` on top: ``get_config()`` holds the file's
   values and ``topK`` 3; ``engine.chunkedPrefill`` off from a file is
   refused with the message the same value from the environment gets,
   and ``engine.pipelineParallelism`` 2 from a file is read as 2.
   (b) The sentences of phase 7's documents embedded on the card go into
   ``faiss`` (flat), ``ivf`` and the in-process ``tpu`` store: for 32
   queries flat gives the exact store's top 4 (scores within 1e-5, equal
   scores as a set), IVF's recall@4 against it is printed, the persisted
   store reopened answers the same, ``milvus`` and ``pgvector`` without
   their client packages raise JAX's ``VectorStoreError``, and the store
   that serves ``faiss`` is ``NativeVectorStore``. (c) The connectors
   over the process engine, greedy: ``ChatTPU().invoke`` and ``.stream``
   (piece by piece), ``TPULlamaIndexLLM.complete``/``stream_complete`` and
   pandasai's ``TPULLM.call`` equal the backend's own text,
   ``ChatTPU(base_url=...)`` over the engine server on the same engine too;
   ``TPUEmbeddings`` equal the runtime embedder's vectors;
   ``TPULlamaIndexRetriever`` over the ``faiss`` collection (2 of phase
   7's documents) equals ``runtime.retrieve``; an ``llm.chat`` span with
   JAX's attributes and ``llm.new_token`` events. (d) ``python -m
   generativeaiexamples_tpu_torch.server`` (``developer_rag``) with only
   ``APP_CONFIG_FILE`` naming its store: 2 documents uploaded, ``/search``
   equal to the in-process hits, one ``/generate`` streamed to
   ``[DONE]``. (e) A profile of (c)'s in-process calls, ``complete``
   kernel by kernel, holds ``int8_matmul_mma``, ``paged_split_kernel`` and
   ``flash_attention_kernel`` (captured again, up to 3 times, when CUPTI
   drops events). It prints the native build's seconds, search ms a query
   for flat, ivf and tpu, and the phase wall (a budget of 120 s). The
   phase runs in a child process of this script (``--connect-child``, as
   phase 13 does: after the earlier phases' profiler sessions in one
   process, a capture came back one kernel short three times running);
   its log lines are relayed and its launches counted in the sum. Every
   process it started is gone when it ends.

16. tp: tensor-parallel serving, every shard on this card
   (``create_mesh(N, devices=[cuda:0] * N)``: each kernel at its per-GPU
   shape of the deployment, and the real f32 reduce). Random int8 packs at
   seed 0, drawn once as a single-device tree, which each TP engine lays
   out per shard and cuts, so both engines compute one function. (a)
   llama3-8b at full width: recipe A at full depth, D at 8 of 32 layers
   (``CUT_LAYERS``, since phase 21) and B and C at 4, each at TP=1 and
   TP=2 (``max_seq_len`` 2048), 8 greedy prompts of 100-1,200 ids
   admitted as one wave x 32 tokens: TP=2's
   streams equal TP=1's, or part at a token whose TP=1 top-1 margin is
   within ``LOGITS_TOL``; every kernel of the recipe launched at TP=2 (each
   shard's launches count); no synchronizing call on the dispatch thread.
   (b) llama3-70b at full width, recipe A at 4 of its 80 layers, TP=8
   against TP=1, 4 prompts, the same checks. (c) the OpenAI-compatible
   engine server in process over the TP=2 recipe-A engine of
   ``create_mesh(2, devices=[cuda:0, cuda:0])`` answers 3 greedy chat
   completions; where the machine shows two cards, a server process
   started with ``APP_ENGINE_TENSORPARALLELISM=2``, its shards on two
   cards, must answer them with the same texts; the phase prints which
   ran. Each leg's largest logits difference between TP=N and TP=1, over
   the prefills of its shortest and its longest prompt, must stay within
   its limit (``TP_LOGITS_LIMITS``). It prints per leg the peak memory
   allocated on the card, the wall of a decode block at TP=N against
   TP=1, that logits difference, the ties and the launches, and the
   phase wall (a budget of 120 s). Phases 1-15 pin
   ``tensor_parallelism=1``, so that what they measure does not change on
   a machine with more cards (the default ``-1`` takes every card).

17. train: checkpoints and fine-tuning at llama3-8b width, everything
   written under the run's scratch directory and removed after. (a) A
   bf16 HF checkpoint of 4 of the 32 layers in 2 safetensors files
   (``hf_loader.write_hf_checkpoint``, drawn on the card at ``--seed``)
   into recipe A's engine from ``checkpoint_path`` alone (its config.json
   is the model) and recipe B's (w8a8, int8 KV): each engine's packs
   byte-equal to ``quantize_params_int8(load_params(...))`` of the same
   files on the card, its 4 greedy streams of 120-900 ids x 16 tokens
   token-identical to an engine given those packs through ``params=``;
   load seconds, GB/s from the (warm) page cache, ``peak_host_bytes``
   against the larger file. (b) The same checkpoint at TP=2, both shards
   on the card: per-shard packs byte-equal to ``shard_params`` of (a)'s,
   streams equal TP=1's but at ties, logits within phase 16's
   ``TP_LOGITS_LIMITS``. (c) An arctic-embed-l-width BERT checkpoint in HF
   naming through ``APP_EMBEDDINGS_CHECKPOINTPATH``: embeddings bit-equal
   to the same tensors given in memory. (d) LoRA at full width and depth
   (32 layers, bf16, dense random weights at ``--seed``): rank 16 on
   wq,wk,wv,wo, B=4, T=256, remat, 6 AdamW steps on one fixed batch; step
   0's loss is the base model's ``sft_loss`` (B = 0), the loss falls, the
   base weights are unchanged bit for bit (version counters, pointers and
   checksums), and a save after step 3 restored into a fresh state gives
   steps 4-6 bitwise the uninterrupted adapters; ms a step, tokens/s, peak
   memory. (e) SFT over every weight at 4 of 32 layers (the embedding and
   head whole), bf16, 4 AdamW steps: the loss falls; a resume from step 2
   within its stated tolerance. (f) (d)'s adapters merged: the dense
   logits against the unmerged forward within ``TRAIN_MERGE_LIMIT``, the
   merged loss below the base's; packed to int8 and served by recipe A's
   engine at full depth: its streams equal the plain path's (the whole
   context recomputed through the plain model each token, on the same
   packs) but at ties. (g) ``generativeaiexamples_tpu_torch.tools.finetune``'s
   ``main`` in this process (since phase 20; child processes before)
   ``--model debug --mode lora --device cuda`` with ``--ckpt-dir`` and
   ``--merge-out``, then ``--resume``: exit 0 and the JSON line. The kernel launches of (a),
   (b) and (f)'s engines count. It prints the phase wall (a budget of 150
   s).

18. tpx: the paths once refused under tensor parallelism, at llama3-8b's
   full width with every shard on this card (``create_mesh(2, devices=
   [cuda:0] * 2)``, phase 16's layout), random int8 packs at seed 0, (a)-(d)
   at 8 of 32 layers (``max_seq_len`` 2048, page 128, ``prefill_chunk``
   512, 8 slots, K = 8). (a) Spec: recipe A's TP=2 engine ``off``, then
   ``lookup``, then ``draft_model`` (``llama3-1b-proxy``, random at seed 0,
   its weights and strips cut over the two shards), and a TP=1 engine on
   ``lookup``; recipe D's TP=2 engine ``off`` then ``lookup``; 4
   copy_heavy prompts x 24 greedy tokens a leg, every stream equal to the
   TP=2 ``off`` stream or parting at a tie (``LOGITS_TOL``); a verify ran
   its matmuls at M = 72 and (A) its page reads at T = 9 on each shard;
   the draft ran on 2 shards; no synchronizing call on the dispatch thread
   but the spec read backs. It prints acceptance, tokens a dispatch and
   the verify's launches. (b) Drain: recipes A and C at TP=2, 4 requests
   (2 greedy, 2 seeded) of 140-900 ids x 48 tokens undrained, then again
   drained mid-decode (the ``engine.dispatch`` delay keeps them live): 4
   documents holding the model's 8 KV heads, each restored into a fresh
   TP=2 engine and into a TP=1 engine in mode ``restore``, spooled plus
   continued tokens equal to the undrained TP=2 stream but at ties. It
   prints drain s, document bytes and restore p50. (c) ``disagg`` at TP=2
   against ``unified`` at TP=2: 4 greedy prompts of 120-1,500 ids equal
   but at ties, one handoff each, no recompute; the tier plan printed. (d)
   The retrieval tier beside the TP=2 engine as the process engine, while
   it decodes: 8 concurrent queries (hash embeddings of phase 7's corpus
   in the in-process store on the card) equal to the synchronous path's
   within ``SEARCH_SCORE_TOL``, tie runs as sets. (e) The port's
   ``profile_decode`` on recipe A at 8 of 32 layers (``TPX_PROFILE_LAYERS``;
   full depth until phase 21), B = 8, TP=1 then TP=2,
   both in one child process of this script (``--tpx-profile-shards 1,2``:
   a fresh profiler state; one a shard count before phase 20) (``ENABLE_PROFILING`` set for the engine's build, so the TP reduce's
   kernels carry their label): 1 s of steady decode and one 512-id
   prefill (the 512 bucket), each trace complete (up to 3 captures), its
   kernels, JAX's categories and top ops printed; ``collective`` is
   non-zero at TP=2 only. The launches of every engine count. It prints
   the phase wall and each part's (a budget of 120 s).

19. pp: pipeline-parallel serving (``parallel/pp_serving.py``) and the ANN
   shard merge, every stage and shard on this card (``create_mesh(tp,
   stages, devices=[cuda:0] * (stages * tp))``), random int8 packs at seed
   0 drawn once as a single-device tree, which each engine lays out per
   stage (``max_seq_len`` 2048, the fixed layout, 8 slots). Each leg
   builds its reference engine and then each PP engine on the same tree,
   one after another, each freed before the next; a PP engine's model
   functions on a 512-id prompt (a prefill and 8 decode steps fed the
   reference's greedy tokens) equal the reference's bit for bit where each
   stage has the reference's shard count, and stay within phase 16's limit
   of recipe D (``PP_TP_LOGITS_LIMIT``) where it has not (PP=2 x TP=2
   against TP=1), greedy parts only at a tie; its served streams
   equal the reference's but at ties (``_tie_checked``); its serving
   launches the leg's kernels on every stage and no ``paged_attention``,
   with the counts set to 0 just before it serves and read just after;
   the dispatch thread makes no synchronizing call. (a) llama3-8b at full
   width and 8 of 32 layers (``CUT_LAYERS``, since phase 21; full depth
   before), int8 weights over int8 strips: TP=1, then PP=2 (4 layers a
   stage), then PP=2 x TP=2; 8 concurrent greedy prompts of
   100-1,200 ids x 32 tokens (one monolithic wave each: the PP path has
   no chunked prefill, as in JAX) and, on PP=2, 3 chat completions behind
   the OpenAI-compatible engine server equal to TP=1's. (b) w8a8 over
   int8 strips and (c) int8 weights over bf16 strips at PP=2, at (a)'s
   depth on its 8 prompts, against TP=1.
   (d) llama3-70b's width at 4 of its 80 layers, PP=2 x TP=8 (16 shards)
   against TP=8. (e) a bf16 checkpoint of 4 layers at llama3-8b width
   (``write_hf_checkpoint``) streamed into PP=2 x TP=2
   (``load_params_pp_streaming``): every tensor byte-equal to the layered
   load's per-shard packs cut into the stages; seconds and
   ``peak_host_bytes``. (f) ROADMAP item 9d: a 65,536 x 1024 store of
   random unit rows, exact and IVF (nlist 64, nprobe 16), one shard
   against two shards on the card: 8 queries at k 4 and 16, indices equal
   but at ties and scores within 1e-5, the device time of a search on
   each. It prints each engine's decode block wall against its
   reference's, the launches and the phase wall (a budget of 100 s).

ppcards (``--phases ppcards``, on 4 cards; not in the default run): phase
   19's leg (a) with each stage and shard on a card of its own (PP=2 over
   two cards, PP=2 x TP=2 over four), against TP=1 on the first.

20. multi: ring attention, sharded training and many processes, on this
   card (no kernel of the port runs here: JAX's ring and training are
   einsum and XLA's matmuls; the phase fails if any of the five launches).
   (a) ``parallel/ring_attention.py`` at llama3-8b's attention widths (Hq
   32, Hkv 8, Dh 128, bf16, B 1, T 8192) over 4 ``seq`` shards of the
   card against ``reference_attention``: max |err| within one bf16 ulp of
   the largest output, both walls. (b) Two LoRA steps (phase 17's r16 on
   wq, wk, wv, wo, B drawn non-zero) at llama3-8b's full width, 8 of 32
   layers (``MULTI_LAYERS``; full depth until phase 21), B 4 x T 1024,
   on tp 2 x dp 2 x sp 2 over ``[cuda:0] * 8`` (``create_mesh(2, 2, 2)``,
   ``make_lora_train_step(..., seq_sharded=True, mesh=)``) against the
   one-device steps from the same state: each loss within
   ``MULTI_LOSS_RTOL``, the signs of A's and B's updates within
   ``MULTI_SIGN_FLIPS``, which a planted fault (the one-device steps on
   data replica 0's rows alone) must exceed; the step's wall and a traced
   step's device busy time and idle share.
   (c) Two processes on the one card through ``tools/launch.py`` running
   the finetune CLI, LoRA, ``--dp 2`` over ``gloo`` (one card can only
   run gloo), on a bf16 checkpoint of llama3-8b's width at 8 layers, 3
   steps, against the in-process ``--dp 2`` run: the checkpointed
   adapters and the final loss equal bit for bit; the backend, the
   gradient all-reduce's ms, the all-reduces' share of the steps' wall
   and the time from the launch until both processes joined the group.
   It prints the phase wall and each part's (a budget of 90 s).

21. apps: the applications built on the stack, on phase 7's deployment
   (llama3-8b at full width and depth, recipe A, phase 6's encoders; it
   runs after phase 10 and before phase 11, and alone builds the
   deployment and ingests phase 7's corpus); every engine request of the
   phase decodes at most 48 tokens (``APPS_TOKENS``). (b) First, alone:
   ``examples/five_min_rag.main(["--docs", <phase 7's 16 files>, "-q",
   ...])`` in process: the ``faiss`` store holds the chunks it printed and
   the answer is not empty. Then (a) beside (c), (d) and (e), as one
   deployment serves several apps: (a) the evaluation harness's ``main``
   in process: ``generate-data`` on one document (the pairs the random
   model's reply parses to are reported), ``generate-answers`` over HTTP
   against the port's chain server (``developer_rag``) for a planted
   ``qna.json`` of 8 questions, one a document of phase 7's corpus (every
   row an answer and a context), ``evaluate`` with engine A as the judge
   and arctic-embed-l for answer similarity: JAX's result keys, every
   score a float in its range, the judge's replies parsed and counted,
   each row's answer similarity finite and their mean the result's; (c)
   the streaming-transcript server (``fm_streaming_rag``) fed 600 words of
   phase 7's corpus in posts of 20 through ``replay``, then 3 greedy
   questions over ``/generate`` and the first again: every SSE frame
   parses, the last is ``[DONE]``, the content is not empty, the two
   answers to the repeated question equal (or part at a tie,
   ``_tie_checked``); TTFT and wall a question; (d) the O-RAN chatbot:
   phase 10's ``report.pdf`` through ``POST /documents``, 2 ``/chat``
   turns with the fact check (two engine calls each), ``/feedback`` then
   ``/feedback/summary`` counting it; (e) the multimodal assistant over
   phase 10's three files, 2 questions. ``int8_matmul`` and
   ``paged_attention`` must launch in the phase. It prints each leg's
   wall, the launches and the phase wall (a budget of 120 s).

22. agents: the rest of the JAX repository's experimental/ on phase 7's
   deployment (it runs after phase 21 and before phase 11, and alone
   builds the deployment and ingests phase 7's corpus); every engine
   request decodes at most 48 tokens (phase 21's ``_AppsEngine``); the
   inputs are drawn from ``--seed``. (a) ingest on arctic-embed-l and the
   card's store, the JAX defaults (512-word chunks, overlap 64, batches of
   64, 2 workers): first ``IngestPipeline`` driven directly with a Kafka
   source over an injected ``poll()`` (128 messages) and 12 code files
   into ``cve_code``, then ``streaming_ingest.run.main(["--files", ...,
   "--rss", ...])`` in process over 96 files of 8-16 KB (.txt, .md and
   .html: a file the loader cannot read, .html without bs4, is skipped, as
   in JAX) and an RSS 2.0 feed of 128 items and an Atom feed of 64 into
   ``agents_ingest``: ``docs_in`` is the readable files, entries and
   messages; ``chunks_out`` and the store's count equal the chunks the
   port's loader and splitter make of the same inputs here, with the same
   (source, text) multiset; 64 stored vectors each within cosine 0.999 of
   a direct ``embed_documents`` of its text; each file's planted opening
   sentence (> 512 bytes, embedded as the chunks are) finds that file at
   top 1. (b) beside (a)'s second run: ``cve_analysis.pipeline.main``
   over 4 CVEs (JSONL) at concurrency 4, a 200-package SBOM and
   ``--code-collection cve_code``: every line has JAX's ``as_dict`` keys,
   the engine requests holding the CVEs equal the calls the verdicts imply;
   ``CodeSearchTool.search`` of each planted identifier equals the host's
   top 4 over the store's vectors (how many hold the planted call is
   reported: the encoder's weights are random). (c) beside them: a
   Triton-protocol stub server here (``GET /v2/health/ready``, ``POST
   /v2/models/ensemble/infer`` decoding ``text_input`` greedily on engine A)
   and ``TritonLLMBackend`` driving one CVE through ``CVEPipeline``:
   ``server_ready()``, JAX's eight input tensors and the bearer token in
   each body, each reply the server's ``text_output``, as many requests as
   the verdict implies. The phase's engine requests are (b)'s and (c)'s,
   none decodes more than 48 tokens, ``int8_matmul`` and ``paged_attention``
   must launch. It prints each leg's wall, chunks a second, the engine
   requests and tokens, the launches and the phase wall (a budget of 60 s).

multicards (``--phases multicards``, on 4 cards; not in the default run):
   phase 20's (b) in one process on tp 2 x dp 2 over four cards
   (``MULTICARDS_MESH``) against one device, and its (c) over ``nccl``,
   one process a card, at 2 and 4 processes against the in-process run
   (``MULTICARDS_LIMITS``).

With no arguments it runs every phase above but ppcards and multicards;
``--phases``,
``--checks`` and ``--recipes`` run a part (for example ``--phases serve
--recipes B``, ``--phases chains``, ``--phases filechains``, ``--phases
drain``, ``--phases observe``, ``--phases route``, ``--phases connect`` or
``--phases kernels,tp --checks tp``, ``--phases train``, ``--phases tpx``,
``--phases pp``, ``--phases multi``, ``--phases retrieval,rag,apps`` or
``--phases agents``)
and then print only the kernels that part measured; ``--runahead N`` serves every engine at ``decode_runahead`` N, and
``--timing-only`` leaves out the runahead and overload checks (for timed
runs of an older tree, which lacks them).

It then prints one JSON line of per-kernel results and, last, the device
line. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.ops import _build
from generativeaiexamples_tpu_torch.ops import decode_attention as da
from generativeaiexamples_tpu_torch.ops import flash_attention as fa
from generativeaiexamples_tpu_torch.ops import int8_matmul as im
from generativeaiexamples_tpu_torch.ops import page_attention as pa
from generativeaiexamples_tpu_torch.utils import device_trace, hardware

MODEL = "llama3-8b"
# the depth of paths that are not the main path's first drive, for the
# script's time: phase 9's A and phase 14's replicas (a bf16 checkpoint of
# this depth) since phase 20 joined, and phase 15's engine (a checkpoint
# too), 16's D, 18 (e), 19 (a)-(c) and 20 (b) since phase 21 joined, run
# llama3-8b's full width at 8 of its 32 layers
CUT_LAYERS = 8
_PAGED = "generativeaiexamples_tpu/ops/page_attention.py:88"
# kernel entry -> (the TPU kernel it replaces, its source in the repo)
KERNELS = {
    "int8_matmul": ("generativeaiexamples_tpu/ops/int8_matmul.py:73",
                    "generativeaiexamples_tpu_torch/csrc/int8_matmul.cu"),
    "paged_attention[bfloat16]": (_PAGED, "generativeaiexamples_tpu_torch/csrc/page_attention.cu"),
    "paged_attention[int8]": (_PAGED, "generativeaiexamples_tpu_torch/csrc/page_attention.cu"),
    "paged_attention[int4]": (_PAGED, "generativeaiexamples_tpu_torch/csrc/page_attention.cu"),
    "flash_attention_causal": ("generativeaiexamples_tpu/ops/flash_attention.py:36",
                               "generativeaiexamples_tpu_torch/csrc/flash_attention.cu"),
    "int8_w8a8_matmul": ("generativeaiexamples_tpu/ops/int8_matmul.py:179",
                         "generativeaiexamples_tpu_torch/csrc/int8_w8a8_matmul.cu"),
    "decode_attention": ("generativeaiexamples_tpu/ops/decode_attention.py:75",
                         "generativeaiexamples_tpu_torch/csrc/decode_attention.cu"),
}
# whether the engine has the reader thread (an older tree's engine, timed
# against this one, decodes synchronously)
_HAS_READER = "decode_runahead" in EngineConfig.__dataclass_fields__
# the serving recipes: (name, quantization, kv_cache_dtype, kv_layout, kernels its path must launch)
RECIPES = (
    ("A", "int8", "bfloat16", "paged",
     ("int8_matmul", "paged_attention[bfloat16]", "flash_attention_causal")),
    ("B", "w8a8", "int8", "paged",
     ("int8_w8a8_matmul", "paged_attention[int8]", "flash_attention_causal")),
    ("C", "int8", "int4", "paged",
     ("int8_matmul", "paged_attention[int4]", "flash_attention_causal")),
    ("D", "int8", "int8", "fixed",
     ("int8_matmul", "decode_attention", "flash_attention_causal")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def _cut_model(layers: int) -> str:
    """The name of llama3-8b's preset cut to its first ``layers`` layers,
    registered in this process."""
    from generativeaiexamples_tpu_torch.models import llama

    name = f"{MODEL}-{layers}-layers"
    llama.PRESETS[name] = dataclasses.replace(llama.PRESETS[MODEL], num_layers=layers)
    return name


# every kernel wrapper's launch count (utils/device_trace.py reads them,
# as the serving process's profile route does)
reset_counts = device_trace.reset_launch_counts
counts = device_trace.launch_counts


class Timer:
    """Median device time of one call: CUDA events around each call, the
    50 MB L2 flushed before it (the serving path finds weights and pages
    cold), and a ~1 ms spin kernel queued ahead of both so the host has
    enqueued the whole call before the device reaches it (the events then
    time the device, not Python's launch overhead)."""

    def __init__(self, device):
        self.flush = torch.zeros(64 * 1024 * 1024, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15, warmup: int = 2, spin: int = 2_000_000) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(spin)
            # evict by reading: a write would leave ~50 MB of dirty lines
            # whose write-back then competes with the timed call
            self.flush.max()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# --------------------------------------------------------------------- #
# Phase 1-2


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    smi = _smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return {"smi": smi}


def phase_build() -> None:
    t0 = time.time()
    reports = _build.build(verbose=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"phase build: ok ({time.time() - t0:.1f} s)")


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_int8(timer, dev, gen, results) -> None:
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "wqkv": (h, cfg.q_dim + 2 * cfg.kv_dim),
        "wo": (cfg.q_dim, h),
        "w_gateup": (h, 2 * f),
        "w_down": (f, h),
        "lm_head": (h, cfg.vocab_size),
    }
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0, "err": 0.0}
    per_shape = {}
    for M in (1, 8):
        for name, (K, F) in shapes.items():
            K_pad = -(-K // im.K_ALIGN) * im.K_ALIGN
            F_pad = -(-F // im.F_BLK) * im.F_BLK
            q = torch.zeros((K_pad, F_pad), dtype=torch.int8, device=dev)
            q[:K, :F].random_(-127, 128, generator=gen)
            scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            y = im.int8_matmul(x, q, scale)
            ref = im.int8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            err = _max_err(y, ref)
            tol = 1e-2 * float(ref.float().abs().max())  # ~2 bf16 ulps of the largest output
            w = (q[:K, :F].float() * scale).to(torch.bfloat16)
            k_ms = timer.ms(lambda: im.int8_matmul(x, q, scale))
            p_ms = timer.ms(lambda: im.int8_matmul_plain(x, q, scale), iters=5)
            l_ms = timer.ms(lambda: torch.matmul(x, w))
            nbytes, flops = hardware.int8_matmul_cost(M, K, F)
            b_ms, b_by = hardware.bound_ms(nbytes, flops)
            ok = err <= tol
            log(f"  int8_matmul {name:8s} M={M} K={K} F={F}: max|err|={err:.4g} tol={tol:.4g} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8_matmul {name} M={M} disagrees with its plain version")
            agg["err"] = max(agg["err"], err)
            per_shape[f"{name}_M{M}"] = {"ms": k_ms, "library_ms": l_ms, "bound_ms": b_ms}
            if M == 8 and name != "lm_head":  # one decoder layer's projections at B=8
                agg["ms"] += k_ms
                agg["plain_ms"] += p_ms
                agg["library_ms"] += l_ms
                agg["bytes"] += nbytes
                agg["flops"] += flops
            if M == 8:
                _check_int8_verify_rows(timer, dev, gen, name, K, F, q, scale, w, per_shape, agg)
            # a padded and a two-group M on the widest-K and a narrow-F shape,
            # correctness only
            if M == 8 and name in ("wqkv", "w_down"):
                for M2 in (4, 16):
                    x2 = torch.randn((M2, K), generator=gen, device=dev).to(torch.bfloat16)
                    y2 = im.int8_matmul(x2, q, scale)
                    ref2 = im.int8_matmul_plain(x2, q, scale)
                    torch.cuda.synchronize()
                    err2, tol2 = _max_err(y2, ref2), 1e-2 * float(ref2.float().abs().max())
                    log(f"  int8_matmul {name:8s} M={M2} K={K} F={F}: max|err|={err2:.4g} "
                        f"tol={tol2:.4g} (not timed) {'ok' if err2 <= tol2 else 'FAIL'}")
                    if err2 > tol2:
                        raise AssertionError(
                            f"int8_matmul {name} M={M2} disagrees with its plain version")
                    agg["err"] = max(agg["err"], err2)
            del q, w
    b_ms, b_by = hardware.bound_ms(agg["bytes"], agg["flops"])
    results["int8_matmul"] = {
        "max_abs_err": agg["err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": agg["library_ms"],
        "shape": "one layer's wqkv+wo+w_gateup+w_down at M=8",
        "per_shape": per_shape,
    }


# the spec verify's rows: 8 slots x (spec_draft_len 8 + 1)
VERIFY_M = 72


def _check_int8_verify_rows(timer, dev, gen, name, K, F, q, scale, w, per_shape, agg) -> None:
    """int8_matmul at the verify's M = 72 rows on one shape, timed with its
    plain version, ``torch.matmul`` on the dequantized bf16 weight and its
    bound."""
    M = VERIFY_M
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    y = im.int8_matmul(x, q, scale)
    ref = im.int8_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    err, tol = _max_err(y, ref), 1e-2 * float(ref.float().abs().max())
    k_ms = timer.ms(lambda: im.int8_matmul(x, q, scale))
    p_ms = timer.ms(lambda: im.int8_matmul_plain(x, q, scale), iters=5)
    l_ms = timer.ms(lambda: torch.matmul(x, w))
    nbytes, flops = hardware.int8_matmul_cost(M, K, F)
    b_ms, b_by = hardware.bound_ms(nbytes, flops)
    ok = err <= tol
    log(f"  int8_matmul {name:8s} M={M} K={K} F={F} (verify rows): max|err|={err:.4g} tol={tol:.4g} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"int8_matmul {name} M={M} disagrees with its plain version")
    agg["err"] = max(agg["err"], err)
    per_shape[f"{name}_M{M}"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                 "bound_ms": b_ms, "bound_by": b_by}


def _paged_case(gen, dev, positions, Pmax, page, Hkv, Dh):
    """Page tables over a shuffled bf16 pool for rows at ``positions``: a
    row at position 0 is dead (its table points at the scratch page 0),
    every other row owns the pages up to its position."""
    B = len(positions)
    live = [p // page + 1 if p else 0 for p in positions]
    P = 1 + sum(live)
    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((B, Pmax), dtype=torch.int32)
    at = 0
    for b, n in enumerate(live):
        tables[b, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    k = torch.randn((P, page, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((P, page, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return k, v, tables.to(dev), pos


def _per_row_rel_err(out, ref) -> float:
    """Max over rows of a call of max|err| / RMS of that row's reference
    outputs: a long row averages thousands of V rows, so its outputs are
    small and an absolute limit set by the short rows would let a fault on
    it pass. One bf16 rounding is 2^-9 of a value."""
    dims = tuple(range(1, out.dim()))
    diff = (out.float() - ref.float()).abs().amax(dim=dims)
    rms = ref.float().pow(2).mean(dim=dims).sqrt().clamp_min(1e-6)
    return float((diff / rms).max())


def check_paged(timer, dev, gen, results) -> None:
    """paged_attention at llama3-8b geometry (B=8, page 128, Pmax 64) for
    each pool (bf16 rows, and the same rows quantized to int8 and int4 with
    their scales) on four sets of rows: ragged (a dead row, a one-page row,
    a full 8191-token row, five at 200-1200), uniform (all at 2047), short
    (the smoke's serving traffic, 100-220 tokens, and a dead row), and
    split edges (rows ending on and just past split boundaries)."""
    from generativeaiexamples_tpu_torch.models.llama import (
        PRESETS, quantize_kv, quantize_kv_int4, unpack_int4,
    )

    cfg = PRESETS[MODEL]
    B, page, Pmax = 8, 128, 8192 // 128
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = Pmax * page
    st = pa.split_plan(Pmax, page)[0]
    ragged = [0, 50, S - 1] + [
        int(x) for x in torch.randint(200, 1200, (B - 3,), generator=gen, device=dev)
    ]
    cases = {
        "ragged": ragged,
        "uniform": [2047] * B,
        "short": [100, 131, 157, 0, 176, 199, 220, 143],
        "edges": [st - 1, st, 2 * st - 1, 2 * st, 0, 1, st + 1, S - 1],
    }
    rows = {kv: {} for kv in pa.KV_DTYPES}
    for case, positions in cases.items():
        k, v, tables, pos = _paged_case(gen, dev, positions, Pmax, page, Hkv, Dh)
        q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
        mask = (torch.arange(S, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        for kv_dtype in pa.KV_DTYPES:
            codec = {"int8": quantize_kv, "int4": quantize_kv_int4}.get(kv_dtype)
            if codec is None:
                pool, scales, dense = (k, v), (None, None), (k, v)
            else:
                (kq, ks), (vq, vs) = codec(k), codec(v)
                pool, scales = (kq, vq), (ks, vs)
                ints = [unpack_int4(t) if t.dtype == torch.uint8 else t for t in pool]
                dense = tuple((i.float() * sc[..., None]).to(torch.bfloat16)
                              for i, sc in zip(ints, scales))
            args = (q, *pool, tables, pos, *scales)
            out = pa.paged_attention(*args)
            ref = pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            # outputs are convex mixes of N(0, 1) rows, f32 inside both, one
            # bf16 rounding of |out| < 1 (< 4e-3); and each row against 5 %
            # of its own RMS
            tol, rel_tol = 1e-2, 0.05
            rel = _per_row_rel_err(out, ref)
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"paged_attention[{kv_dtype}] {case}: non-finite values (dead row?)")
            k_ms = timer.ms(lambda: pa.paged_attention(*args))
            p_ms = timer.ms(lambda: pa.paged_attention_plain(*args), iters=5)
            # yardstick: SDPA over the rows' pre-gathered (dequantized) bf16
            # windows with a length mask
            gk, gv = (t[tables.long()].reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous()
                      for t in dense)
            l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, gk, gv, attn_mask=mask, enable_gqa=True))
            del gk, gv
            nbytes, flops = hardware.paged_attention_cost(
                [[p] for p in positions], Hq, Hkv, Dh, Pmax,
                kv_bytes=hardware.kv_bytes_per_element(kv_dtype),
                scale_bytes=0 if codec is None else 4,
            )
            b_ms, b_by = hardware.bound_ms(nbytes, flops)
            ok = err <= tol and rel <= rel_tol
            log(f"  paged_attention[{kv_dtype}] {case} B={B} positions={positions}: "
                f"max|err|={err:.4g} tol={tol} max per-row |err|/rms={rel:.4g} tol={rel_tol} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_attention[{kv_dtype}] {case} disagrees with its plain version")
            rows[kv_dtype][case] = {
                "max_abs_err": err, "max_rel_err": rel, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            }
        del k, v
    _check_paged_verify(timer, dev, gen, (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim), rows)
    for kv_dtype, by_case in rows.items():
        results[f"paged_attention[{kv_dtype}]"] = {
            **by_case["ragged"],
            "max_abs_err": max(r["max_abs_err"] for r in by_case.values()),
            "max_rel_err": max(r["max_rel_err"] for r in by_case.values()),
            "shape": f"B=8 decode rows over ragged tables, Hq=32 Hkv=8 Dh=128 page=128, "
                     f"{kv_dtype} pool",
            **{case: {**r, **({"positions": cases[case]} if case in cases else {})}
               for case, r in by_case.items() if case != "ragged"},
        }


# the spec verify's query rows a slot: K + 1 at spec_draft_len 8, then the
# adaptive-K ladder's 4, 2 and 1
VERIFY_T = (9, 5, 3, 2)


def _check_paged_verify(timer, dev, gen, heads, rows, Ts=VERIFY_T, label="") -> None:
    """paged_attention at the spec verify's T = K + 1 query rows a slot,
    for each pool, on ``heads`` (Hq, Hkv, Dh): 8 rows whose chunks end at
    their live lengths (a dead row, a chunk crossing the page edge at 256,
    one crossing a split edge, short serving rows, the table's last row),
    timed against the plain version, SDPA over the pre-gathered windows
    with a causal length mask, and the bound; each row lands in
    ``rows[kv_dtype]["<label>verify_T<T>"]``."""
    from generativeaiexamples_tpu_torch.models.llama import quantize_kv, quantize_kv_int4, unpack_int4

    B, page, Pmax = 8, 128, 8192 // 128
    Hq, Hkv, Dh = heads
    S = Pmax * page
    st = pa.split_plan(Pmax, page)[0]
    for T in Ts:
        # each row's last query position (its live length - 1); row 0 dead
        last = [0, 2 * page + T // 2 - 1, st + 1, 131, 157, 176, 1000, S - 1]
        k, v, tables, _ = _paged_case(gen, dev, last, Pmax, page, Hkv, Dh)
        first = [0] + [p - (T - 1) for p in last[1:]]
        pos = torch.tensor(first, dtype=torch.int32, device=dev)
        q = torch.randn((B, T, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
        q_pos = torch.clamp(pos.long()[:, None] + torch.arange(T, device=dev)[None, :], max=S - 1)
        mask = (torch.arange(S, device=dev)[None, None, :] <= q_pos[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        for kv_dtype in pa.KV_DTYPES:
            codec = {"int8": quantize_kv, "int4": quantize_kv_int4}.get(kv_dtype)
            if codec is None:
                pool, scales, dense = (k, v), (None, None), (k, v)
            else:
                (kq, ks), (vq, vs) = codec(k), codec(v)
                pool, scales = (kq, vq), (ks, vs)
                ints = [unpack_int4(t) if t.dtype == torch.uint8 else t for t in pool]
                dense = tuple((i.float() * sc[..., None]).to(torch.bfloat16)
                              for i, sc in zip(ints, scales))
            args = (q, *pool, tables, pos, *scales)
            out = pa.paged_attention(*args)
            ref = pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            rel = _per_row_rel_err(out.flatten(0, 1), ref.flatten(0, 1))
            tol, rel_tol = 1e-2, 0.05  # as the decode rows: f32 inside, one bf16 rounding
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"paged_attention[{kv_dtype}] verify T={T}: non-finite values")
            k_ms = timer.ms(lambda: pa.paged_attention(*args))
            p_ms = timer.ms(lambda: pa.paged_attention_plain(*args), iters=5)
            gk, gv = (t[tables.long()].reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous()
                      for t in dense)
            l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, gk, gv, attn_mask=mask, enable_gqa=True))
            del gk, gv
            nbytes, flops = hardware.paged_attention_cost(
                [[min(p + t, S - 1) for t in range(T)] for p in first], Hq, Hkv, Dh, Pmax,
                kv_bytes=hardware.kv_bytes_per_element(kv_dtype),
                scale_bytes=0 if codec is None else 4,
            )
            b_ms, b_by = hardware.bound_ms(nbytes, flops)
            ok = err <= tol and rel <= rel_tol
            log(f"  paged_attention[{kv_dtype}] {label}verify T={T} Hq={Hq} Hkv={Hkv} B={B} "
                f"last={last}: max|err|={err:.4g} "
                f"tol={tol} max per-row |err|/rms={rel:.4g} tol={rel_tol} kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_attention[{kv_dtype}] {label}verify T={T} disagrees "
                                     f"with its plain version")
            rows[kv_dtype][f"{label}verify_T{T}"] = {
                "max_abs_err": err, "max_rel_err": rel, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms, "last": last,
            }
        del k, v


def check_w8a8(timer, dev, gen, results) -> None:
    """int8_w8a8_matmul (one launch, its quantizer inside) at the four fused
    projections and the lm_head, bitwise against its plain version (exact
    int32 sums and the same f32 quantizer on both sides) with bf16 x at
    M = 1, 8, 16, 72 and 128 and f32 x at M = 8, every case timed; at M = 1 and
    8 and at the spec verify's M = 72 also the plain version, the
    ``torch._int_mm`` yardstick and ``int8_matmul`` on the same pack,
    which streams the same bytes."""
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "wqkv": (h, cfg.q_dim + 2 * cfg.kv_dim),
        "wo": (cfg.q_dim, h),
        "w_gateup": (h, 2 * f),
        "w_down": (f, h),
        "lm_head": (h, cfg.vocab_size),
    }
    cases = ((1, torch.bfloat16), (8, torch.bfloat16), (16, torch.bfloat16),
             (VERIFY_M, torch.bfloat16), (128, torch.bfloat16), (8, torch.float32))
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "int8_matmul_ms": 0.0, "bytes": 0,
           "flops": 0, "err": 0.0}
    per_shape = {}
    for name, (K, F) in shapes.items():
        K_pad = -(-K // im.K_ALIGN) * im.K_ALIGN
        F_pad = -(-F // im.F_BLK) * im.F_BLK
        q = torch.zeros((K_pad, F_pad), dtype=torch.int8, device=dev)
        q[:K, :F].random_(-127, 128, generator=gen)
        scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
        for M, dtype in cases:
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            y = im.int8_w8a8_matmul(x, q, scale)
            ref = im.int8_w8a8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            err = _max_err(y, ref)
            ok = torch.equal(y, ref)  # exact int32 sums and one epilogue on both sides
            k_ms = timer.ms(lambda: im.int8_w8a8_matmul(x, q, scale))
            nbytes, ops = hardware.w8a8_matmul_cost(M, K, F, x_bytes=x.element_size())
            b_ms, b_by = hardware.bound_ms(nbytes, ops, int8=True)
            label = f"{name}_M{M}" + ("_f32" if dtype == torch.float32 else "")
            row = {"ms": k_ms, "bound_ms": b_ms}
            extra = ""
            if (M <= 8 or M == VERIFY_M) and dtype == torch.bfloat16:
                row["plain_ms"] = timer.ms(lambda: im.int8_w8a8_matmul_plain(x, q, scale), iters=5)
                # yardstick: cuBLAS int8 x int8 -> int32 on the quantized
                # rows, padded to _int_mm's least M (17)
                xq = torch.zeros((max(17, M), K_pad), dtype=torch.int8, device=dev)
                xq[:M, :K] = im.quantize_rows(x)[0]
                row["library_ms"] = timer.ms(lambda: torch._int_mm(xq, q))
                row["int8_matmul_ms"] = timer.ms(lambda: im.int8_matmul(x, q, scale))
                del xq
                extra = (f" plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                         f"int8_matmul_ms={row['int8_matmul_ms']:.4f}")
            log(f"  int8_w8a8_matmul {name:8s} M={M} K={K} F={F} x={str(dtype)[6:]}: bitwise={ok} "
                f"max|err|={err:.4g} kernel_ms={k_ms:.4f}{extra} bound_ms={b_ms:.4f} ({b_by}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8_w8a8_matmul {label} differs from its plain version")
            agg["err"] = max(agg["err"], err)
            per_shape[label] = row
            if M == 8 and dtype == torch.bfloat16 and name != "lm_head":  # one layer at B=8
                for key in ("ms", "plain_ms", "library_ms", "int8_matmul_ms"):
                    agg[key] += row[key]
                agg["bytes"] += nbytes
                agg["flops"] += ops
        del q
    b_ms, b_by = hardware.bound_ms(agg["bytes"], agg["flops"], int8=True)
    results["int8_w8a8_matmul"] = {
        "max_abs_err": agg["err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": agg["library_ms"],
        "shape": "one layer's wqkv+wo+w_gateup+w_down at M=8, bf16 x, quantizer included",
        "int8_matmul_ms": agg["int8_matmul_ms"],  # the weight-only kernel on the same packs
        "per_shape": per_shape,
    }


def check_flash(timer, dev, gen, results) -> None:
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = worst_rel = 0.0
    for B, T in ((2, 512), (2, 300)):
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        out = fa.flash_attention_causal(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        # |out| < ~3; the kernel rounds the probabilities to bf16 before its
        # P.V product on the tensor cores (the plain version keeps them
        # f32), which can move an output in [2, 4) across a rounding
        # boundary: one bf16 step there is 2^-6 = 0.0156 (the f32 kernel's
        # worst was 0.0078, one step in [1, 2))
        tol = 2e-2
        # each query row (b, t, h) against 5 % of its own RMS: late rows
        # average hundreds of V rows, so their outputs are small. (Over a
        # whole (b, h) the RMS is set by those small rows while the largest
        # error is one bf16 step of an early O(1) row, so that measure sits
        # near 0.05 for any kernel that rounds like the plain version.)
        rel = _per_row_rel_err(out.flatten(0, 2), ref.flatten(0, 2))
        rel_tol = 0.05
        k_ms = timer.ms(lambda: fa.flash_attention_causal(q, k, v))
        p_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v), iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes, flops = hardware.flash_attention_cost(B, T, Hq, Hkv, D)
        b_ms, b_by = hardware.bound_ms(nbytes, flops)
        ok = err <= tol and rel <= rel_tol
        log(f"  flash_attention_causal B={B} T={T}: max|err|={err:.4g} tol={tol} "
            f"max per-row |err|/rms={rel:.4g} tol={rel_tol} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_causal T={T} disagrees with its plain version")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        if T == 512:
            results["flash_attention_causal"] = {
                "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms,
                "shape": "B=2 T=512 Hq=32 Hkv=8 D=128",
            }
    results["flash_attention_causal"]["max_abs_err"] = worst
    results["flash_attention_causal"]["max_rel_err"] = worst_rel


def check_decode(timer, dev, gen, results) -> None:
    """decode_attention over the fixed layout's int8 head-major cache at
    llama3-8b geometry and the engine's capacity (B=8, S=8192), for a
    ragged batch (one slot at 8191, six at 100-160, a dead slot at 0) and a
    uniform one (every slot at 2047), the smoke's serving traffic (seven
    slots at 100-220 and a dead slot) and slots ending on and just past the
    kernel's split boundaries."""
    from generativeaiexamples_tpu_torch.models.llama import PRESETS, quantize_kv

    cfg = PRESETS[MODEL]
    B, S = 8, 8192
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_q, k_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    v_q, v_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    k_s, v_s = k_s[:, :, None, :].contiguous(), v_s[:, :, None, :].contiguous()
    q = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
    # yardstick: SDPA over the dequantized bf16 strips with a length mask
    kd = (k_q.float() * k_s[:, :, 0, :, None]).to(torch.bfloat16)
    vd = (v_q.float() * v_s[:, :, 0, :, None]).to(torch.bfloat16)
    cases = {
        "ragged": [8191, 100, 112, 125, 131, 144, 160, 0],
        "uniform": [2047] * B,
        "short": [100, 131, 157, 0, 176, 199, 220, 143],
        "split_edge": [511, 512, 1023, 1024, 4095, 4096, 8191, 0],
    }
    out_rows = {}
    for case, positions in cases.items():
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        args = (q, k_q, k_s, v_q, v_s, pos)
        out = da.decode_attention(*args)
        ref = da.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        tol = 1e-2  # outputs are convex mixes of N(0, 1) rows; f32 inside, one bf16 rounding
        # each slot against its own size as well (a long strip's outputs
        # are ~sqrt(e / rows))
        rel = _per_row_rel_err(out, ref)
        rel_tol = 0.05
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"decode_attention[{case}] returned non-finite values")
        k_ms = timer.ms(lambda: da.decode_attention(*args))
        p_ms = timer.ms(lambda: da.decode_attention_plain(*args), iters=5)
        mask = (torch.arange(S, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
        l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))
        nbytes, flops = hardware.decode_attention_cost(positions, Hq, Hkv, Dh, S=S)
        b_ms, b_by = hardware.bound_ms(nbytes, flops)
        ok = err <= tol and rel <= rel_tol
        log(f"  decode_attention[{case}] B={B} S={S} positions={positions}: max|err|={err:.4g} "
            f"tol={tol} max per-slot |err|/rms={rel:.4g} tol={rel_tol} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention[{case}] disagrees with its plain version")
        out_rows[case] = {
            "max_abs_err": err, "max_rel_err": rel, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
        }
    del kd, vd
    results["decode_attention"] = {
        **out_rows["ragged"],
        "max_abs_err": max(r["max_abs_err"] for r in out_rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in out_rows.values()),
        "shape": "B=8 decode slots over an int8 fixed cache S=8192, Hq=32 Hkv=8 Dh=128, ragged "
                 "positions (8191, six at 100-160, a dead slot at 0)",
        **{case: {**out_rows[case], "positions": cases[case]} for case in cases if case != "ragged"},
    }


# the shards' local tiles of llama3-8b at TP=2 and llama3-70b at TP=8 (the
# serving path of phase 16): name -> (K, F) of each projection a shard
TP_TILES_8B = {"wq": (4096, 2048), "wk/wv": (4096, 512), "wo": (2048, 4096),
               "w_gate/w_up": (4096, 7168), "w_down": (7168, 4096), "lm_head": (4096, 64128)}
TP_TILES_70B = {"wq": (8192, 1024), "w_gate": (8192, 3584), "w_down": (3584, 8192)}
# attention heads a shard: (Hq, Hkv) of llama3-8b at TP=2 and llama3-70b at TP=8
TP_HEADS = {"8b_tp2": (16, 4), "70b_tp8": (8, 1)}


def _tile_row(timer, kernel, plain, library, args, cost, int8_ops=False) -> dict:
    """One local tile timed: the kernel, its plain version and a library
    call, with its bound."""
    k_ms = timer.ms(lambda: kernel(*args))
    p_ms = timer.ms(lambda: plain(*args), iters=3)
    l_ms = timer.ms(library)
    b_ms, b_by = hardware.bound_ms(*cost, int8=int8_ops)
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_tp(timer, dev, gen, results) -> None:
    """Each kernel on the local tiles a shard runs under tensor parallelism
    (phases 16 and 18), against its plain version: int8_matmul and
    int8_w8a8_matmul at M = 8 and at the spec verify's M = 72 on llama3-8b
    TP=2's column and row tiles, int8_matmul at M = 8 on llama3-70b TP=8's,
    paged_attention at 16/4 and 8/1 heads on all three pools (B=8 ragged
    rows) and at the verify's T = 9 query rows a slot on 16/4 heads,
    decode_attention at 16/4 heads (B=8, S=8192) and flash at 16/4 heads
    (B=2, T=512); each timed with its plain version, a library call and
    its bound."""
    from generativeaiexamples_tpu_torch.models.llama import quantize_kv, quantize_kv_int4, unpack_int4

    tiles = results.setdefault("tp_tiles", {})
    for model, shapes in (("8b_tp2", TP_TILES_8B), ("70b_tp8", TP_TILES_70B)):
        for name, (K, F) in shapes.items():
            K_pad, F_pad = -(-K // im.K_ALIGN) * im.K_ALIGN, -(-F // im.F_BLK) * im.F_BLK
            q = torch.zeros((K_pad, F_pad), dtype=torch.int8, device=dev)
            q[:K, :F].random_(-127, 128, generator=gen)
            scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
            w = (q[:K, :F].float() * scale).to(torch.bfloat16)
            kernels = [("int8_matmul", im.int8_matmul, im.int8_matmul_plain)]
            if model == "8b_tp2":
                kernels.append(("int8_w8a8_matmul", im.int8_w8a8_matmul, im.int8_w8a8_matmul_plain))
            for M, (kname, kernel, plain) in ((M, k) for M in ((8, VERIFY_M) if model == "8b_tp2"
                                                                else (8,)) for k in kernels):
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                y, ref = kernel(x, q, scale), plain(x, q, scale)
                torch.cuda.synchronize()
                err = _max_err(y, ref)
                if kname == "int8_matmul":
                    tol = 1e-2 * float(ref.float().abs().max())
                    ok, cost = err <= tol, hardware.int8_matmul_cost(M, K, F)
                    library = lambda: torch.matmul(x, w)  # noqa: E731
                else:
                    tol, ok = 0.0, torch.equal(y, ref)
                    cost = hardware.w8a8_matmul_cost(M, K, F)
                    xq = torch.zeros((max(M, 17), K_pad), dtype=torch.int8, device=dev)
                    xq[:M, :K] = im.quantize_rows(x)[0]
                    library = lambda: torch._int_mm(xq, q)  # noqa: E731
                row = _tile_row(timer, kernel, plain, library, (x, q, scale), cost,
                                int8_ops=kname != "int8_matmul")
                row["max_abs_err"] = err
                log(f"  {kname} {model} tile {name:11s} M={M} K={K} F={F}: max|err|={err:.4g} "
                    f"tol={tol:.4g} kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                    f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                    f"({row['bound_by']}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{kname} {model} tile {name} disagrees with its plain version")
                tiles.setdefault(kname, {})[f"{model}_{name}_M{M}"] = row
            del q, w
    # the spec verify's T = K + 1 rows a slot through a shard's heads
    Hq, Hkv = TP_HEADS["8b_tp2"]
    _check_paged_verify(timer, dev, gen, (Hq, Hkv, 128),
                        {kv: tiles.setdefault(f"paged_attention[{kv}]", {}) for kv in pa.KV_DTYPES},
                        Ts=(9,), label="8b_tp2_")
    # attention on a shard's heads
    B, page, Pmax, Dh = 8, 128, 64, 128
    S = Pmax * page
    positions = [0, 50, S - 1] + [int(p) for p in torch.randint(200, 1200, (B - 3,), generator=gen,
                                                                  device=dev)]
    for model, (Hq, Hkv) in TP_HEADS.items():
        k, v, tables, pos = _paged_case(gen, dev, positions, Pmax, page, Hkv, Dh)
        q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
        mask = (torch.arange(S, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
        for kv_dtype in pa.KV_DTYPES:
            codec = {"int8": quantize_kv, "int4": quantize_kv_int4}.get(kv_dtype)
            if codec is None:
                pool, scales, dense = (k, v), (None, None), (k, v)
            else:
                (kq, ks), (vq, vs) = codec(k), codec(v)
                pool, scales = (kq, vq), (ks, vs)
                ints = [unpack_int4(t) if t.dtype == torch.uint8 else t for t in pool]
                dense = tuple((i.float() * sc[..., None]).to(torch.bfloat16) for i, sc in zip(ints, scales))
            args = (q, *pool, tables, pos, *scales)
            out, ref = pa.paged_attention(*args), pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err, rel = _max_err(out, ref), _per_row_rel_err(out, ref)
            ok = err <= 1e-2 and rel <= 0.05 and bool(torch.isfinite(out.float()).all())
            gk, gv = (t[tables.long()].reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous() for t in dense)
            qt = q.transpose(1, 2)
            row = _tile_row(
                timer, pa.paged_attention, pa.paged_attention_plain,
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, gk, gv, attn_mask=mask, enable_gqa=True),
                args, hardware.paged_attention_cost(
                    [[p] for p in positions], Hq, Hkv, Dh, Pmax,
                    kv_bytes=hardware.kv_bytes_per_element(kv_dtype),
                    scale_bytes=0 if codec is None else 4))
            del gk, gv
            row.update(max_abs_err=err, max_rel_err=rel)
            log(f"  paged_attention[{kv_dtype}] {model} heads Hq={Hq} Hkv={Hkv} B={B} ragged: "
                f"max|err|={err:.4g} tol=0.01 max per-row |err|/rms={rel:.4g} tol=0.05 "
                f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_attention[{kv_dtype}] {model} disagrees with its plain version")
            tiles.setdefault(f"paged_attention[{kv_dtype}]", {})[f"{model}_ragged"] = row
        del k, v
    Hq, Hkv = TP_HEADS["8b_tp2"]
    k_q, k_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    v_q, v_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    k_s, v_s = k_s[:, :, None, :].contiguous(), v_s[:, :, None, :].contiguous()
    qd = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
    kd = (k_q.float() * k_s[:, :, 0, :, None]).to(torch.bfloat16)
    vd = (v_q.float() * v_s[:, :, 0, :, None]).to(torch.bfloat16)
    dpos = torch.tensor(positions, dtype=torch.int32, device=dev)
    args = (qd, k_q, k_s, v_q, v_s, dpos)
    out, ref = da.decode_attention(*args), da.decode_attention_plain(*args)
    torch.cuda.synchronize()
    err, rel = _max_err(out, ref), _per_row_rel_err(out, ref)
    ok = err <= 1e-2 and rel <= 0.05
    dmask = (torch.arange(S, device=dev)[None, :] <= dpos.long()[:, None])[:, None, None, :]
    row = _tile_row(timer, da.decode_attention, da.decode_attention_plain,
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qd[:, :, None, :], kd, vd, attn_mask=dmask, enable_gqa=True),
                    args, hardware.decode_attention_cost(positions, Hq, Hkv, Dh, S=S))
    row.update(max_abs_err=err, max_rel_err=rel)
    log(f"  decode_attention 8b_tp2 heads Hq={Hq} Hkv={Hkv} B={B} S={S} ragged: max|err|={err:.4g} "
        f"tol=0.01 max per-slot |err|/rms={rel:.4g} tol=0.05 kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode_attention 8b_tp2 disagrees with its plain version")
    tiles.setdefault("decode_attention", {})["8b_tp2_ragged"] = row
    del k_q, v_q, kd, vd
    Bf, T = 2, 512
    qf = torch.randn((Bf, T, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
    kf, vf = (torch.randn((Bf, T, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    out, ref = fa.flash_attention_causal(qf, kf, vf), fa.flash_attention_plain(qf, kf, vf)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    rel = _per_row_rel_err(out.flatten(0, 2), ref.flatten(0, 2))
    ok = err <= 2e-2 and rel <= 0.05
    qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
    row = _tile_row(timer, fa.flash_attention_causal, fa.flash_attention_plain,
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True),
                    (qf, kf, vf), hardware.flash_attention_cost(Bf, T, Hq, Hkv, Dh))
    row.update(max_abs_err=err, max_rel_err=rel)
    log(f"  flash_attention_causal 8b_tp2 heads Hq={Hq} Hkv={Hkv} B={Bf} T={T}: max|err|={err:.4g} "
        f"tol=0.02 max per-row |err|/rms={rel:.4g} tol=0.05 kernel_ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_causal 8b_tp2 disagrees with its plain version")
    tiles.setdefault("flash_attention_causal", {})["8b_tp2_T512"] = row


CHECKS = {"int8": check_int8, "w8a8": check_w8a8, "paged": check_paged, "flash": check_flash,
          "decode": check_decode, "tp": check_tp}


SAMPLE_ROWS = (8, 72)  # a decode step's rows; a verify's B x (K + 1)


def time_sampling(timer, dev) -> dict:
    """``sample_tokens`` on the card at a decode step's 8 rows and a
    verify's 72, x 128,256 f32 logits, every row seeded nucleus (top_p
    0.8): its time with each way of ranking the nucleus' top 64
    (``nucleus_top_k``, the int64-key top-k; ``torch.topk``, whose order
    among tied values is not JAX's; a stable sort of the whole row), the
    ranking alone, and the key's order held to the stable sort's on tied
    logits. No kernel of the port: the ranking's cost on the main path."""
    from generativeaiexamples_tpu_torch.models import sampling

    ways = {
        "key_topk": sampling.nucleus_top_k,
        "torch_topk": lambda x, K: torch.topk(x, K, dim=-1),
        "stable_sort": lambda x, K: tuple(
            t[..., :K] for t in torch.sort(x, dim=-1, descending=True, stable=True)),
    }
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    saved = sampling.nucleus_top_k
    try:
        for R in SAMPLE_ROWS:
            logits = torch.randn((R, 128256), generator=gen, device=dev) * 3.0
            tied = torch.round(logits * 4.0) / 4.0  # exact ties inside the top 64
            want = ways["stable_sort"](tied, 64)
            got = sampling.nucleus_top_k(tied, 64)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"sampling R={R}: the key's order is not the stable sort's")
            temp = torch.full((R,), 0.7, device=dev)
            top_p = torch.full((R,), 0.8, device=dev)
            keys = sampling.sample_keys(torch.arange(R, device=dev) + 1234,
                                        torch.arange(R, device=dev) + 600)
            row = {}
            for name, way in ways.items():
                sampling.nucleus_top_k = way
                row[f"sample_{name}_ms"] = timer.ms(
                    lambda: sampling.sample_tokens(logits, temp, top_p, keys), spin=50_000_000)
                row[f"rank_{name}_ms"] = timer.ms(lambda: way(logits, 64))
                sampling.nucleus_top_k = saved
            out[f"R{R}"] = row
            log(f"  sample_tokens at {R} x 128256, seeded nucleus: "
                + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
                + " ms; the key's order equals the stable sort's on tied logits")
    finally:
        sampling.nucleus_top_k = saved
    return out


def phase_kernels(dev, checks=tuple(CHECKS)) -> dict:
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict = {}
    one = torch.zeros(16, device=dev)
    log(f"  timer floor (one 16-element add_, the same timing): {timer.ms(lambda: one.add_(1)):.4f} ms")
    for name in checks:
        CHECKS[name](timer, dev, gen, results)
    results["sampling"] = time_sampling(timer, dev)
    del timer
    torch.cuda.empty_cache()
    log(f"  launches in this phase (checks and timing, not the serving path): {counts()}")
    log("phase kernels: ok")
    return results


# --------------------------------------------------------------------- #
# Phase 4: model level, kernel path against plain path

# Max |logits difference| allowed between the kernel path and the plain
# path: activations are bf16 through 32 layers, and the two paths round
# differently (the einsum reference rounds probabilities to bf16 before
# P.V, the kernels keep them in f32; split-K and tiled sums change f32
# order), a few bf16 ulps per layer on O(1) activations and logits.
# Under w8a8 the per-token int8 activations turn such a difference into a
# whole quantization step (1/127 of a row's absmax) wherever a rounding
# flips, so recipe B drifts most (0.35 against A's 0.10 on the H100); the
# greedy tokens must still agree wherever the top-2 margin exceeds the
# tolerance.
LOGITS_TOL = 0.5


def phase_model(dev) -> None:
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    t0 = time.time()
    cfg = llama.PRESETS[MODEL]
    page, steps = 128, 8
    lengths = [512, 300]
    B, T = len(lengths), 512
    gen = torch.Generator(device=dev).manual_seed(1)
    # one set of int8 packs serves every recipe (w8a8 runs on the same packs)
    params = quant.init_packed_params_int8(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    tokens = torch.randint(0, 512, (B, T), generator=gen, device=dev)
    lengths_d = torch.tensor(lengths, device=dev)
    per_row = -(-(T + steps) // page)
    tables = (1 + torch.arange(B * per_row, device=dev, dtype=torch.int32)).reshape(B, per_row)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    def run(quant_kernel, kv_dtype, kernels: bool, forced=None):
        pool = llama.init_kv_pool(
            cfg, 1 + B * per_row, page, torch.bfloat16, dev,
            quantized=kv_dtype != "bfloat16", packed=kv_dtype == "int4",
        )
        logits, kvs = llama.prefill_layers(
            params, cfg, tokens, lengths_d, use_flash=kernels, quant_kernel=quant_kernel
        )
        llama.write_prefill_pages(pool, kvs, tables, page)
        del kvs
        out = [logits]
        toks = []
        pos = lengths_d.clone()
        for s in range(steps):
            nxt = torch.argmax(out[-1], dim=-1) if forced is None else forced[s]
            toks.append(nxt)
            logits, _ = llama.decode_layers_paged(
                params, cfg, nxt, pos, live, tables, pool, window=per_row * page,
                page_size=page, quant_kernel=quant_kernel, page_kernel=kernels,
            )
            out.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        return torch.stack(out), toks

    S_fixed = per_row * page  # the fixed strips hold the same rows as a paged row
    slots = torch.arange(B, device=dev)

    def run_fixed(kernels: bool, forced=None):
        """The fixed layout with int8 weights and an int8 head-major cache
        read by decode_attention (kernel path) or decode_attention_xla
        (plain path)."""
        qk = None if kernels else False
        cache = llama.init_kv_cache_layers(cfg, B, S_fixed, torch.bfloat16, dev, quantized=True)
        logits, kvs = llama.prefill_layers(params, cfg, tokens, lengths_d, use_flash=kernels,
                                           quant_kernel=qk)
        llama.write_prefill_slots(cache, kvs, slots)
        del kvs
        out, toks, pos = [logits], [], lengths_d.clone()
        for s in range(steps):
            nxt = torch.argmax(out[-1], dim=-1) if forced is None else forced[s]
            toks.append(nxt)
            logits, _ = llama.decode_layers(params, cfg, nxt, pos, cache, window=S_fixed,
                                            quant_kernel=qk, kv_kernel=kernels)
            out.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        return torch.stack(out), toks

    def compare(label, k_logits, p_logits, t1):
        """Max |dlogits| within LOGITS_TOL, and the greedy tokens equal
        wherever the reference's top-2 margin exceeds it."""
        if not bool(torch.isfinite(k_logits).all()):
            raise AssertionError(f"{label}: non-finite logits")
        diff = float((k_logits - p_logits).abs().max())
        top2 = torch.topk(p_logits, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        agree = torch.argmax(k_logits, -1) == torch.argmax(p_logits, -1)
        bad = int(((margin > LOGITS_TOL) & ~agree).sum())
        log(f"  model {MODEL} (L={cfg.num_layers}, hidden {cfg.hidden_size}, vocab {cfg.vocab_size}), "
            f"{label}: prefill B={B} T={T} + {steps} decode steps: max|dlogits|={diff:.4g} "
            f"tol={LOGITS_TOL} greedy agree {int(agree.sum())}/{agree.numel()} (disagreements "
            f"where margin > tol: {bad}) logits shape {tuple(k_logits.shape)} "
            f"({time.time() - t1:.1f} s)")
        if diff > LOGITS_TOL or bad:
            raise AssertionError(f"{label}: the two paths disagree at model level")

    for name, quantization, kv_dtype, layout, _ in RECIPES:
        if layout != "paged":
            continue
        t1 = time.time()
        # quant_kernel values of the kernel path and of the plain path
        qk_kernel, qk_plain = ("w8a8", "w8a8_plain") if quantization == "w8a8" else (None, False)
        with torch.inference_mode():
            k_logits, k_toks = run(qk_kernel, kv_dtype, True)
            p_logits, _ = run(qk_plain, kv_dtype, False, forced=k_toks)  # same inputs at every step
        compare(f"recipe {name} ({quantization} weights, {kv_dtype} KV), kernel vs plain path",
                k_logits, p_logits, t1)
        del k_logits, p_logits

    with torch.inference_mode():
        t1 = time.time()
        f_logits, f_toks = run_fixed(True)
        p_logits, _ = run_fixed(False, forced=f_toks)
        compare("recipe D (int8 weights, int8 fixed cache), decode_attention kernel vs plain "
                "path", f_logits, p_logits, t1)
        t1 = time.time()
        g_logits, _ = run(None, "int8", True, forced=f_toks)
        compare("int8 weights + int8 KV, fixed layout kernel path vs paged layout kernel path",
                f_logits, g_logits, t1)
        del f_logits, p_logits, g_logits
    del params
    torch.cuda.empty_cache()
    log(f"phase model: ok ({time.time() - t0:.1f} s)")


# --------------------------------------------------------------------- #
# Phase 5: serve over HTTP


def _post(base, path, body, timeout=600):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def device_step_ms(engine) -> list:
    """Device times (sorted, ms) of five decode steps of the serving model at
    B=8 (kernel path, the engine's layout, KV dtype and quantization,
    160-token contexts), CUDA events around each step with a ~0.5 s spin
    kernel queued ahead and Python's collector off, so the host has enqueued
    the whole step before the device starts it: no launch gaps are timed.
    (torch.profiler does not see every launch of the ctypes-loaded kernels,
    so it is not used.)"""
    from generativeaiexamples_tpu_torch.models import llama

    cfg, dev, page = engine.model_config, engine.device, engine.engine_config.page_size
    B, per_row = engine.num_slots, 2
    tokens = torch.arange(B, device=dev) * 31 % 250
    positions = torch.full((B,), 160, device=dev)
    if engine._paged:
        pool = llama.init_kv_pool(
            cfg, 1 + B * per_row, page, torch.bfloat16, dev,
            quantized=engine._kv_quant, packed=engine._kv_packed,
        )
        tables = (1 + torch.arange(B * per_row, device=dev, dtype=torch.int32)).reshape(B, per_row)
        live = torch.ones(B, dtype=torch.bool, device=dev)

        def step():
            logits, _ = llama.decode_layers_paged(
                engine.params, cfg, tokens, positions, live, tables, pool,
                window=per_row * page, page_size=page, quant_kernel=engine._quant_kernel,
                page_kernel=True,
            )
            torch.argmax(logits, dim=-1)
    else:
        # per-slot strips of the same 256 rows; the decode kernel reads only
        # each slot's live rows, whatever the capacity
        cache = llama.init_kv_cache_layers(
            cfg, B, per_row * page, torch.bfloat16, dev, quantized=engine._kv_quant
        )

        def step():
            logits, _ = llama.decode_layers(
                engine.params, cfg, tokens, positions, cache, window=per_row * page,
                quant_kernel=engine._quant_kernel, kv_kernel=engine._kv_kernel,
            )
            torch.argmax(logits, dim=-1)

    times = []
    gc.disable()  # a collection mid-enqueue would outlast the spin and be timed
    try:
        with torch.inference_mode():
            step()
            for _ in range(5):
                torch.cuda._sleep(1_000_000_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            launches = launches_per_step(step)
    finally:
        gc.enable()
    return sorted(times), launches


def launches_per_step(step) -> dict:
    """Kernel launches of one decode step: those torch.profiler's device
    trace shows, split into PyTorch's and the port's, and the port's
    kernel launches as the wrappers counted them (the trace may miss
    launches from the ctypes-loaded libraries)."""
    from torch.profiler import ProfilerActivity, profile

    before = sum(device_trace.kernel_counts().values())
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - a measurement, reported as not measured
        log(f"  launches per step: not measured ({exc!r})")
        return {}
    calls = sum(device_trace.kernel_counts().values()) - before
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    port = sum(1 for n in names if device_trace.PORT_KERNEL_NAMES.search(n))
    return {"torch": len(names) - port, "port_seen": port, "port_calls": calls,
            "total": len(names) - port + max(port, calls)}


def _http_requests(engine, base) -> None:
    """Four concurrent requests over HTTP; every one must answer 200 with
    the OpenAI wire shape."""
    errors, results = [], {}

    def call(name, path, body):
        try:
            results[name] = _post(base, path, body)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc!r}")

    long_text = "Context: " + ("the quick brown fox jumps over the lazy dog. " * 16)
    requests = {
        "chat_stream": ("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hello."}],
            "stream": True, "max_tokens": 32, "temperature": 0.7, "seed": 7}),
        "chat": ("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "What is a GPU?"}],
            "max_tokens": 32, "temperature": 0}),
        "completions": ("/v1/completions", {
            "prompt": "Once upon a time", "max_tokens": 32, "temperature": 0}),
        "chat_long": ("/v1/chat/completions", {
            "messages": [{"role": "user", "content": long_text + "Summarize."}],
            "max_tokens": 24, "temperature": 0}),
    }
    threads = [
        threading.Thread(target=call, args=(n, p, b), name=f"smoke-{n}", daemon=True)
        for n, (p, b) in requests.items()
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if errors:
        raise AssertionError("; ".join(errors))
    for name, (status, text) in results.items():
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status}")
    frames = [ln[6:] for ln in results["chat_stream"][1].split("\n\n") if ln.startswith("data: ")]
    if not frames or frames[-1] != "[DONE]":
        raise AssertionError("SSE stream does not end in data: [DONE]")
    for fr in frames[:-1]:
        obj = json.loads(fr)
        assert obj["object"] == "chat.completion.chunk", obj
    assert json.loads(results["chat"][1])["choices"][0]["message"]["role"] == "assistant"
    assert json.loads(results["completions"][1])["object"] == "text_completion"
    long_ids = len(engine.tokenizer.render_chat([("user", long_text + "Summarize.")]))
    assert long_ids > engine.engine_config.prefill_chunk, long_ids
    log(f"  HTTP: chat stream {len(frames) - 1} chunks + [DONE], chat, completions, "
        f"long chat ({long_ids} prompt ids, chunked prefill): all 200")


class SyncCounter:
    """Counts PyTorch's synchronizing CUDA calls by thread name while it is
    entered: ``torch.cuda.set_sync_debug_mode("warn")`` makes each one (a
    blocking copy either way, ``.item()``, ``.cpu()``, a stream or device
    synchronize) warn in the thread that made it. ``kinds`` counts them by
    (thread, kind), the kind being the one the engine declared for the
    call (``spec_decode.allowed_sync``: speculative decoding's read backs)
    or None. Entering also checks that a probe thread's ``.item()`` is
    counted."""

    _MESSAGE = "synchronizing"

    def __enter__(self):
        from generativeaiexamples_tpu_torch.engine.spec_decode import sync_kind

        self.counts = collections.Counter()
        self.kinds = collections.Counter()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=f".*{self._MESSAGE}")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if self._MESSAGE in str(message):
                self.counts[threading.current_thread().name] += 1
                self.kinds[(threading.current_thread().name, sync_kind())] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        probe = threading.Thread(target=lambda: torch.ones(1, device="cuda").item(),
                                 name="smoke-sync-probe", daemon=True)
        probe.start()
        probe.join(60)
        if self.counts.pop("smoke-sync-probe", 0) < 1:
            self.__exit__(None, None, None)
            raise AssertionError("sync debug mode did not report a probe thread's .item()")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False


def check_wait_releases_the_gil() -> None:
    """The reader thread's wait (``torch.cuda.Event.synchronize``) must
    release the GIL, or the dispatch thread stalls behind it: a thread
    waits on an event queued behind a ~0.2 s spin kernel while this thread
    counts Python loop iterations, against its rate alone."""
    def spin(stop) -> float:
        """Python loop iterations a second until ``stop()``."""
        n, t0 = 0, time.perf_counter()
        while not stop():
            n += 1
        return n / (time.perf_counter() - t0)

    t_end = time.perf_counter() + 0.05
    alone = spin(lambda: time.perf_counter() >= t_end)
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    event = torch.cuda.Event()
    event.record()
    waited, done = {}, threading.Event()

    def wait():
        t0 = time.perf_counter()
        event.synchronize()
        waited["s"] = time.perf_counter() - t0
        done.set()

    thread = threading.Thread(target=wait, name="smoke-gil-probe", daemon=True)
    thread.start()
    during = spin(done.is_set)
    thread.join(60)
    share = during / alone
    log(f"  a thread's torch.cuda.Event.synchronize() waited {waited['s'] * 1e3:.1f} ms; "
        f"meanwhile this thread ran its Python loop at {share:.0%} of its rate alone "
        f"({'the wait releases the GIL' if share > 0.3 else 'the wait HOLDS the GIL'})")
    if waited["s"] < 0.05 or share <= 0.3:
        raise AssertionError("the reader's event wait does not release the GIL (or did not wait)")


def _drain_ids(q, timeout=600) -> list:
    out = []
    while (tok := q.get(timeout=timeout)) is not None:
        out.append(tok)
    return out


def check_runahead_and_overload(engine, config) -> dict:
    """A second engine on the same weights at decode_runahead 1, built with
    max_queued_requests = max_batch_size: one batch of 7 greedy rows and a
    seeded sampled row streams the same on both engines. Then, over HTTP,
    8 long requests fill its slots and 16 concurrent completions arrive:
    as many as fit wait and the rest answer 429 with Retry-After and
    X-GenAI-Queue-Depth; aborting the long requests lets the waiting ones
    answer 200."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    B = config.max_batch_size
    other = LLMEngine(dataclasses.replace(config, decode_runahead=1, max_queued_requests=B),
                      device=engine.device, params=engine.params)
    server = make_server("127.0.0.1", 0, engine=other)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http-overload", daemon=True)
    thread.start()
    try:
        prompts = [[256] + [(11 * i + j) % 250 for j in range(60 + 9 * i)] for i in range(B)]
        params = [SamplingParams(temperature=0.0, max_tokens=32)] * (B - 1) + [
            SamplingParams(temperature=0.8, top_p=0.9, max_tokens=32, seed=1234)]
        runs = []
        for eng in (engine, other):
            queues = [eng.generate_ids(p, sp) for p, sp in zip(prompts, params)]
            runs.append((eng.engine_config.decode_runahead, [_drain_ids(q) for q in queues]))
        (ra, a), (rb, b) = runs
        if a != b:
            raise AssertionError(f"streams differ between decode_runahead {ra} and {rb}")
        log(f"  runahead: {B} streams (7 greedy, 1 seeded sampled; lengths {[len(x) for x in a]}) "
            f"identical at decode_runahead {ra} and {rb}")

        hogs = [other.submit(p, SamplingParams(temperature=0.0, max_tokens=4000)) for p in prompts]
        deadline = time.time() + 120
        while (other.queue_depth() or len(other._slot_req) < B) and time.time() < deadline:
            time.sleep(0.01)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        results = []

        def call(i):
            req = urllib.request.Request(
                base + "/v1/completions", headers={"Content-Type": "application/json"},
                data=json.dumps({"prompt": f"request {i}", "max_tokens": 8, "temperature": 0}).encode())
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    results.append((resp.status, dict(resp.headers)))
            except urllib.error.HTTPError as exc:
                results.append((exc.code, dict(exc.headers)))

        callers = [threading.Thread(target=call, args=(i,), name=f"smoke-overload-{i}", daemon=True)
                   for i in range(2 * B)]
        for c in callers:
            c.start()
        deadline = time.time() + 120
        while len(results) + other.queue_depth() < 2 * B and time.time() < deadline:
            time.sleep(0.01)
        depth = other.queue_depth()
        for h in hogs:
            other.abort(h)
        for c in callers:
            c.join(600)
        status = collections.Counter(code for code, _ in results)
        shed = [h for code, h in results if code == 429]
        headers_ok = all("Retry-After" in h and "X-GenAI-Queue-Depth" in h for h in shed)
        log(f"  overload over HTTP (max_queued_requests {B}, {B} slots held): {2 * B} concurrent "
            f"completions -> {dict(status)}, {depth} waited; every 429 with Retry-After and "
            f"X-GenAI-Queue-Depth: {headers_ok}")
        if not (status[429] >= 1 and status[200] >= 1 and status[429] + status[200] == 2 * B
                and headers_ok):
            raise AssertionError(f"overload over HTTP: {dict(status)}, headers {headers_ok}")
        return {"runahead_identical": True, "overload_status": dict(status)}
    finally:
        server.shutdown()
        server.server_close()
        other.shutdown()


def serve_recipe(dev, name, quantization, kv_dtype, layout, expected, http: bool,
                 runahead=None, extras=False) -> dict:
    """Build one engine, serve it (HTTP when ``http``, then 8 greedy
    generate_ids) counting each thread's synchronizing calls, and check
    that its path launched its kernels and its dispatch thread never
    waited for the card. Returns its decode metrics and the launch counts
    of its serving run. ``extras`` adds the runahead and overload checks."""
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    t0 = time.time()
    config = EngineConfig(model_config_name=MODEL, quantization=quantization,
                          kv_cache_dtype=kv_dtype, kv_layout=layout, tensor_parallelism=1)
    if runahead is not None:
        config = dataclasses.replace(config, decode_runahead=runahead)
    engine = LLMEngine(config, device=dev)
    if engine._paged != (layout == "paged"):
        raise AssertionError(f"engine {name}: kv_layout={layout!r} did not resolve to {layout}")
    kv = (f"{kv_dtype} paged pool {engine._pool_pages} pages x {config.page_size}" if engine._paged
          else f"{kv_dtype} fixed cache {engine.num_slots} slots x {engine.max_seq_len} rows")
    log(f"  engine {name} built ({time.time() - t0:.1f} s): {MODEL} {quantization} weights, "
        f"{kv}, max_batch_size {config.max_batch_size}, prefill_chunk {config.prefill_chunk}, "
        f"decode_block {config.decode_block}, decode_runahead "
        f"{getattr(config, 'decode_runahead', 'none (synchronous decode)')}")
    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counts()
        t_serve = time.time()
        start = engine.stats()
        with SyncCounter() as syncs:
            if http:
                _http_requests(engine, base)

            # a full decode batch through the engine's own entry point, by ids
            before = engine.stats()
            prompts = [[256] + [(7 * i + j) % 250 for j in range(100 + 8 * i)] for i in range(8)]
            params = SamplingParams(temperature=0.0, max_tokens=64)
            t_batch = time.time()
            queues = [engine.generate_ids(p, params) for p in prompts]
            counts_ids = []
            for q in queues:
                n = 0
                while q.get(timeout=600) is not None:
                    n += 1
                counts_ids.append(n)
            batch_s = time.time() - t_batch
            after = engine.stats()
        launched = counts()
        stop_ids = set(engine.tokenizer.stop_ids())
        assert all(0 < n <= 64 for n in counts_ids), counts_ids
        t_total = time.time() - t_serve
        log(f"  engine {name} generate_ids x8 (greedy, max_tokens 64): ids per request "
            f"{counts_ids} (fewer than 64 only when a stop id {sorted(stop_ids)} was drawn) in "
            f"{batch_s:.3f} s from submit to the last end ({sum(counts_ids) / batch_s:.1f} ids/s)")
        log(f"  engine {name} launches while serving: {launched}")
        missing = [n for n in expected if launched[n] == 0]
        if missing:
            raise AssertionError(f"engine {name}: kernels never launched while serving: {missing}")
        blocks = after["decode_blocks"] - start.get("decode_blocks", 0)
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        reader_waits = after.get("readbacks", 0) - start.get("readbacks", 0)
        log(f"  engine {name} synchronizing calls while serving, by thread: "
            f"{dict(syncs.counts) or 'none'}; dispatch thread {dispatch_syncs} in "
            f"{blocks} decode blocks ({dispatch_syncs / max(blocks, 1):.2f} a block); reader "
            f"waits on events {reader_waits} (readbacks of {blocks} decode blocks and "
            f"{after['prefill_waves'] - start['prefill_waves']} prefill waves)")
        if _HAS_READER and dispatch_syncs:
            raise AssertionError(f"engine {name}: the dispatch thread waited for the card "
                                 f"{dispatch_syncs} times")
        d_rows = after["decode_rows"] - before.get("decode_rows", 0)
        d_time = after["decode_time_s"] - before.get("decode_time_s", 0.0)
        d_steps = after["decode_steps"] - before.get("decode_steps", 0)
        weight_bytes = hardware.streamed_weight_bytes(engine.params)
        serve = {
            "decode_tokens_per_s": d_rows / d_time,
            "decode_step_ms": 1e3 * d_time / d_steps,
            "decode_mfu": hardware.mfu_ratio(
                d_rows / d_time, hardware.matmul_params(engine.model_config)),
            "decode_weight_hbm_share": hardware.hbm_ratio(weight_bytes * d_steps / d_time),
            "ttft_mean_s": after.get("ttft_mean_s"),
            "ttft_max_s": after.get("ttft_max_s"),
            "launches": launched,
            "serve_s": t_total,
            # submit to the last end of the 8-request batch, prefill included
            "batch_s": batch_s,
            "batch_tokens_per_s": sum(counts_ids) / batch_s,
            "dispatch_syncs": dispatch_syncs,
            "dispatch_syncs_per_block": dispatch_syncs / max(blocks, 1),
            "reader_waits": reader_waits,
            "syncs_by_thread": dict(syncs.counts),
            "decode_blocks": blocks,
        }
        samples, serve["launches_per_step"] = device_step_ms(engine)
        serve["device_step_ms"] = statistics.median(samples)
        serve["device_step_ms_samples"] = samples
        serve["device_idle_share"] = max(0.0, 1.0 - serve["device_step_ms"] / serve["decode_step_ms"])
        log(f"  engine {name} decode at B=8: {serve['decode_tokens_per_s']:.1f} tokens/s, step "
            f"{serve['decode_step_ms']:.2f} ms (wall time of decode blocks, the engine's "
            f"decode_time_s); MFU {serve['decode_mfu']:.2%}, weight streaming at "
            f"{serve['decode_weight_hbm_share']:.1%} of peak HBM rate; one step on the device "
            f"{serve['device_step_ms']:.2f} ms (median of {', '.join(f'{t:.2f}' for t in samples)}; "
            f"idle {serve['device_idle_share']:.1%}); TTFT mean {serve['ttft_mean_s']:.3f} s "
            f"max {serve['ttft_max_s']:.3f} s over all requests; launches per decode step "
            f"{serve['launches_per_step'] or 'not measured'}")
        if extras:
            serve.update(check_runahead_and_overload(engine, config))
        return serve
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def phase_serve(dev, recipes="ABCD", runahead=None, extras=True) -> dict:
    t0 = time.time()
    serves = {}
    if _HAS_READER:
        check_wait_releases_the_gil()
    for name, quantization, kv_dtype, layout, expected in RECIPES:
        if name not in recipes:
            continue
        serves[name] = serve_recipe(dev, name, quantization, kv_dtype, layout, expected,
                                    http=name != "C", runahead=runahead,
                                    extras=extras and _HAS_READER and name == "A")
        gc.collect()  # the engine and its dispatch thread reference each other
        torch.cuda.empty_cache()
        log(f"  after engine {name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    log(f"phase serve: ok ({time.time() - t0:.1f} s)")
    return serves


# --------------------------------------------------------------------- #
# Phase 6: the retrieval side of RAG (embedder, store, reranker, HTTP)

EMBED_MODEL, RERANK_MODEL = "arctic-embed-l", "arctic-embed-m"
# bounds, each from a CPU run of the same functions in bf16 against f32
# (cosine ~0.99993, max |d| ~1.8e-3, logits |d| ~8e-3 at full width)
CARD_VS_CPU_COS, CARD_VS_CPU_ABS, LOGIT_ABS = 0.999, 1e-2, 5e-2
# the batched path against the synchronous one, and a row alone against
# the same row in a batch, on one device: bitwise where both dispatch the
# same shapes; elsewhere cuBLAS tiles another shape differently, and one
# flipped bf16 rounding grows through 24 layers to the size of the bf16
# vs f32 difference (the card's first run: cosine 0.99990, max |d| 1.7e-3),
# so the same bounds hold
SAME_DEVICE_COS, SAME_DEVICE_ABS = CARD_VS_CPU_COS, CARD_VS_CPU_ABS
SEARCH_TOL = 1e-4  # f32 dot products of 1024-dim unit vectors, other sum orders


def _texts(rng, n, lo, hi) -> list:
    """``n`` passages of ``lo``-``hi`` byte-tokenizer ids (ASCII: one id a
    character), drawn from ``rng``."""
    alphabet = list("abcdefghijklmnopqrstuvwxyz     ")
    return ["".join(rng.choice(alphabet, int(n_ids))) for n_ids in rng.randint(lo, hi + 1, n)]


def _params_on(params, dev) -> int:
    """Tensors of a parameter tree; raises unless every one lives on ``dev``."""
    tensors = [t for k, t in params.items() if k != "layers"] + [
        t for lp in params["layers"] for t in lp.values()]
    off = [t.device for t in tensors if t.device.type != dev.type]
    if off:
        raise AssertionError(f"{len(off)} parameters off the card ({off[0]})")
    return sum(t.numel() for t in tensors)


def _cpu_f32(tree):
    from generativeaiexamples_tpu_torch.models.convert import _map

    return _map(tree, lambda t: t.detach().to("cpu", torch.float32))


def _pad(rows, T):
    import numpy as np

    ids = np.zeros((len(rows), T), np.int32)
    mask = np.zeros((len(rows), T), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _row_stats(a, b):
    """(min cosine, max |a - b|, rows bitwise equal) of two [N, D] arrays."""
    import numpy as np

    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    same = int(sum(np.array_equal(x, y) for x, y in zip(a, b)))
    return float(cos.min()), float(np.abs(a - b).max()), same


def _check_topk(got_s, got_i, want_s, want_i, tol, what) -> None:
    """Scores within ``tol``; indices equal where the neighbours' scores
    are more than ``tol`` away (torch.topk orders ties as it likes)."""
    import numpy as np

    if np.abs(got_s - want_s).max() > tol:
        raise AssertionError(f"{what}: scores differ by {np.abs(got_s - want_s).max():.3g}")
    for r in range(want_s.shape[0]):
        k = want_s.shape[1]
        for j in range(k):
            gap = min(abs(want_s[r, j] - want_s[r, j - 1]) if j else np.inf,
                      abs(want_s[r, j] - want_s[r, j + 1]) if j + 1 < k else np.inf)
            if gap > tol and got_i[r, j] != want_i[r, j]:
                raise AssertionError(f"{what}: row {r} rank {j}: {got_i[r, j]} != {want_i[r, j]}")


def _profile_encode(emb, dev, R, T, smi) -> dict:
    """Where one encoder dispatch of ``R`` x ``T`` ids spends the card's
    time: torch.profiler's device events by kernel name (the top 6), the
    kernel count, and the host's wall time to enqueue the dispatch against
    the device's time for it."""
    from torch.profiler import ProfilerActivity, profile

    from generativeaiexamples_tpu_torch.models import bert

    ids = torch.randint(0, 256, (R, T), device=dev, dtype=torch.int32)
    mask = torch.ones((R, T), device=dev, dtype=torch.int32)
    with torch.inference_mode():
        bert.bert_encode(emb._params, emb._cfg, ids, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bert.bert_encode(emb._params, emb._cfg, ids, mask)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                bert.bert_encode(emb._params, emb._cfg, ids, mask)
                torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - a measurement, reported as not measured
            log(f"  profile {R}x{T}: not measured ({exc!r})")
            return {}
    by_name = collections.Counter()
    kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.device_time_total / 1e3
            kernels += 1
    total = sum(by_name.values())
    top = by_name.most_common(6)
    log(f"  profile of one {R}x{T} dispatch: {kernels} kernels, {total:.2f} ms of device time; "
        f"the host enqueues it in {enqueue_ms:.2f} ms; top: "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in top) + f" on {smi}")
    return {"kernels": kernels, "device_ms": total, "enqueue_ms": enqueue_ms,
            "top": [[n, ms] for n, ms in top]}


def phase_retrieval(dev, smi, seed=0, keep=False):
    """arctic-embed-l and arctic-embed-m at full width on the card (random
    weights from ``seed``): the card against the CPU's f32 plain path,
    batched against synchronous, a 65,536 x 1024 store searched exact and
    IVF against numpy, reranking, and /v1/embeddings beside a decoding
    engine A whose dispatch thread must make no synchronizing call.
    Returns the results and, when ``keep``, the (embedder, reranker) pair
    still open for phase 7 (else None)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.config import BatchingConfig
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.retrieval.store import Chunk
    from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

    t0 = time.time()
    out = {}
    rng = np.random.RandomState(seed)
    timer = Timer(dev)

    # 1. both models on the card at full width
    emb = TorchEmbedder(model_name=EMBED_MODEL, batching=BatchingConfig(), device=dev, seed=seed)
    rr = TorchReranker(model_name=RERANK_MODEL, batching=BatchingConfig(), device=dev, seed=seed)
    try:
        ecfg, rcfg = emb._cfg, rr._cfg
        n_emb = _params_on(emb._params, dev)
        n_rr = _params_on(rr._params, dev) + sum(t.numel() for t in rr._head.values())
        if any(t.device.type != dev.type for t in rr._head.values()):
            raise AssertionError("the rank head is off the card")
        log(f"  {EMBED_MODEL}: {ecfg.num_layers} layers, hidden {ecfg.hidden_size}, "
            f"{ecfg.num_heads} heads, FFN {ecfg.intermediate_size}, {n_emb / 1e6:.1f} M parameters "
            f"({bert.matmul_params(ecfg) / 1e6:.1f} M in matmuls), bf16 on {dev}; {RERANK_MODEL}: "
            f"{rcfg.num_layers} layers, hidden {rcfg.hidden_size}, {n_rr / 1e6:.1f} M; random "
            f"weights (seed {seed}), byte tokenizer")

        # 2. the card (bf16) against the CPU (f32 plain path, same weights)
        texts4 = _texts(rng, 4, 64, 256)
        card = emb.embed_documents(texts4)
        rows4 = [emb._tok.encode(t) for t in texts4]
        ids, mask = _pad(rows4, max(len(r) for r in rows4))
        with torch.inference_mode():
            cpu = bert.bert_encode(_cpu_f32(emb._params), ecfg, ids, mask).numpy()
        cos = (card * cpu).sum(-1) / np.linalg.norm(card, axis=-1) / np.linalg.norm(cpu, axis=-1)
        err = float(np.abs(card - cpu).max())
        ok = cos.min() >= CARD_VS_CPU_COS and err <= CARD_VS_CPU_ABS
        log(f"  card (bf16) vs CPU (f32) on 4 passages of {[len(r) for r in rows4]} ids: cosine per "
            f"row {[round(float(c), 6) for c in cos]}, max|d| {err:.4g} (bounds: cosine >= "
            f"{CARD_VS_CPU_COS}, max|d| <= {CARD_VS_CPU_ABS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's embeddings disagree with the CPU's f32 plain path")
        out["card_vs_cpu"] = {"min_cos": float(cos.min()), "max_abs": err}

        # 3. 512 passages through the batched path, then the synchronous one
        texts = _texts(rng, 512, 32, 512)
        n_ids = sum(len(emb._tok.encode(t)) for t in texts)
        paths = {}
        for name, batched in (("batched", True), ("sync", False)):
            emb.set_batching(batched)
            before = emb.counters["device_dispatches"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vecs = emb.embed_documents(texts)
            wall = time.perf_counter() - t1
            paths[name] = (vecs, wall, emb.counters["device_dispatches"] - before)
        emb.set_batching(True)
        (vb, wb, db), (vs, ws, ds) = paths["batched"], paths["sync"]
        cos_bs, abs_bs, same_bs = _row_stats(vb, vs)
        # a row alone (1 row at its own bucket) against the same row in its batch of 32
        alone_idx = list(rng.choice(512, 8, replace=False))
        alone = np.stack([emb._dispatch_rows([emb._tok.encode(texts[i])], 1)[0] for i in alone_idx])
        cos_a, abs_a, same_a = _row_stats(alone, vb[alone_idx])
        ok = (same_bs == 512 or (cos_bs >= SAME_DEVICE_COS and abs_bs <= SAME_DEVICE_ABS)) and (
            same_a == 8 or (cos_a >= SAME_DEVICE_COS and abs_a <= SAME_DEVICE_ABS))
        log(f"  512 passages ({n_ids} ids, 32-512 each): batched {wb:.3f} s in {db} dispatches "
            f"({512 / wb:.1f} passages/s, {n_ids / wb:.0f} tokens/s), synchronous {ws:.3f} s in "
            f"{ds} dispatches ({512 / ws:.1f} passages/s, {n_ids / ws:.0f} tokens/s) on {smi}")
        log(f"  batched vs synchronous: {same_bs}/512 rows bitwise, min cosine {cos_bs:.7f}, max|d| "
            f"{abs_bs:.3g}; 8 rows alone vs in their batch of 32: {same_a}/8 bitwise, min cosine "
            f"{cos_a:.7f}, max|d| {abs_a:.3g} (bound when not bitwise: cosine >= {SAME_DEVICE_COS}, "
            f"max|d| <= {SAME_DEVICE_ABS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("batched and synchronous embeddings disagree")
        out["embed"] = {
            "passages": 512, "ids": n_ids, "batched_s": wb, "sync_s": ws,
            "batched_dispatches": db, "sync_dispatches": ds,
            "batched_passages_per_s": 512 / wb, "batched_tokens_per_s": n_ids / wb,
            "sync_passages_per_s": 512 / ws, "sync_tokens_per_s": n_ids / ws,
            "batched_vs_sync_bitwise_rows": same_bs, "batched_vs_sync_max_abs": abs_bs,
            "alone_vs_batch_bitwise_rows": same_a, "alone_vs_batch_max_abs": abs_a,
        }
        dispatch = {}
        for R, T in ((32, 512), (32, 128), (1, 64)):
            d_ids = torch.randint(0, 256, (R, T), device=dev, dtype=torch.int32)
            d_mask = torch.ones((R, T), device=dev, dtype=torch.int32)
            with torch.inference_mode():
                ms = timer.ms(lambda: bert.bert_encode(emb._params, ecfg, d_ids, d_mask), iters=10)
            flops = hardware.encoder_flops(ecfg, R, T)
            share = flops / (ms * 1e-3) / (hardware.PEAK_TFLOPS * 1e12)
            dispatch[f"{R}x{T}"] = {"ms": ms, "tflop": flops / 1e12, "peak_share": share}
            log(f"  embed dispatch ({R} rows x {T} ids): {ms:.3f} ms on the device (median of 10, "
                f"CUDA events), {flops / 1e12:.3f} TFLOP, {share:.1%} of the dense bf16 peak "
                f"({hardware.PEAK_TFLOPS:.0f} TFLOP/s) on {smi}")
        out["embed"]["dispatch"] = dispatch
        out["embed"]["profile"] = {
            shape: _profile_encode(emb, dev, R, T, smi) for shape, (R, T) in
            (("32x512", (32, 512)), ("1x64", (1, 64)))}

        # 4. a 65,536 x 1024 store: the 512 embeddings and seeded unit vectors
        N = 65536
        filler = rng.standard_normal((N - 512, ecfg.hidden_size)).astype(np.float32)
        filler /= np.linalg.norm(filler, axis=1, keepdims=True)
        corpus = np.concatenate([vb, filler])
        chunks = [Chunk(text=t, source=f"p{i}") for i, t in enumerate(texts)] + [
            Chunk(text=f"synthetic passage {i}", source="synthetic") for i in range(N - 512)]
        stores = {}
        for mode in ("exact", "ivf"):
            t1 = time.perf_counter()
            store = TorchVectorStore(ecfg.hidden_size, ann_mode=mode, nlist=64, nprobe=16, device=dev)
            store.add(chunks, corpus)
            store._ann_engine()
            stores[mode] = store
            log(f"  store[{mode}]: {store.count()} rows x {ecfg.hidden_size} f32 "
                f"({store._matrix.nbytes / 2**20:.0f} MiB) on the card in "
                f"{time.perf_counter() - t1:.2f} s (IVF: k-means on the host, nlist 64)")
        questions = [f"question {i}: " + t[:60] for i, t in enumerate(_texts(rng, 8, 40, 120))]
        queries = np.stack([emb.embed_query(q) for q in questions])
        matrix = stores["exact"]._matrix
        want_s = np.sort(matrix @ queries.T, axis=0)[::-1][:16].T
        want_i = np.argsort(-(matrix @ queries.T), axis=0, kind="stable")[:16].T
        ex_s, ex_i = stores["exact"]._ann.search(queries, 16)
        _check_topk(ex_s, ex_i, want_s, want_i, SEARCH_TOL, "exact search vs numpy")
        log(f"  exact search of 8 embed_query vectors, k 16: scores within "
            f"{float(np.abs(ex_s - want_s).max()):.3g} of numpy's brute force (limit {SEARCH_TOL}), "
            f"indices equal outside ties: ok")
        iv_s, iv_i = stores["ivf"]._ann.search(queries, 16)
        recall = {k: float(np.mean([len(set(iv_i[r, :k]) & set(ex_i[r, :k])) / k
                                    for r in range(8)])) for k in (4, 16)}
        search_ms = {}
        for mode, store in stores.items():
            eng = store._ann
            corp = eng._corpus
            nprobe = min(16, corp.centroids.shape[0]) if mode == "ivf" else 0
            for R in (1, 8):
                q_dev = torch.from_numpy(np.ascontiguousarray(queries[:R])).to(dev)
                for k in (4, 16):
                    with torch.inference_mode():
                        ms = timer.ms(lambda: eng._topk(corp, q_dev, k, nprobe))
                    # one query: the synchronous path (the row ladder's one
                    # row); eight: the batched path (padded to ann_max_batch)
                    call = ((lambda: store.search(queries[0], k)) if R == 1
                            else (lambda: store.search_batch(queries[:R], k)))
                    t1 = time.perf_counter()
                    for _ in range(5):
                        call()
                    wall = (time.perf_counter() - t1) / 5 * 1e3
                    b_ms, b_by = hardware.bound_ms(*hardware.search_cost(
                        R, corp.capacity, ecfg.hidden_size, 64 if mode == "ivf" else 0))
                    search_ms[f"{mode}_r{R}_k{k}"] = {"ms": ms, "wall_ms": wall, "bound_ms": b_ms}
                    if R == 1:
                        # the same query through the batched path, padded to
                        # ann_max_batch rows (the retrieval tier's dispatch)
                        t1 = time.perf_counter()
                        for _ in range(5):
                            store.search_batch(queries[:1], k)
                        padded = (time.perf_counter() - t1) / 5 * 1e3
                        search_ms[f"{mode}_r{R}_k{k}"]["padded_wall_ms"] = padded
                        log(f"  search[{mode}] one query padded to {eng._max_batch} rows k {k}: "
                            f"{padded:.3f} ms wall for store.search_batch on {smi}")
                    log(f"  search[{mode}] rows {R} k {k}: {ms:.4f} ms on the device, "
                        f"{wall:.3f} ms wall for store.{'search' if R == 1 else 'search_batch'}, "
                        f"bound {b_ms:.4f} ms ({b_by}) "
                        f"on {smi}")
        log(f"  IVF (nlist 64, nprobe 16) recall against exact: @4 {recall[4]:.3f}, @16 "
            f"{recall[16]:.3f}")
        out["search"] = {"ms": search_ms, "ivf_recall": recall}

        # 5. rerank each query's top 16
        rerank_ms = []
        first_pairs = None
        for r, q in enumerate(questions):
            passages = [chunks[int(i)].text for i in ex_i[r]]
            t1 = time.perf_counter()
            logits = rr.score(q, passages)
            rerank_ms.append((time.perf_counter() - t1) * 1e3)
            if r == 0:
                first_pairs, first_logits = rr._tokenize_pairs(q, passages), logits
        T = max(len(p[0]) for p in first_pairs)
        ids, mask = _pad([p[0] for p in first_pairs], T)
        types, _ = _pad([p[1] for p in first_pairs], T)
        with torch.inference_mode():
            cpu_logits = bert.cross_encode_score(
                _cpu_f32(rr._params), {k: v.to("cpu", torch.float32) for k, v in rr._head.items()},
                rcfg, ids, mask, types).numpy()
        lerr = float(np.abs(first_logits - cpu_logits).max())
        ok = lerr <= LOGIT_ABS and bool(np.isfinite(first_logits).all())
        log(f"  rerank top 16 of each of 8 queries: {statistics.median(rerank_ms):.2f} ms median "
            f"wall a query ({', '.join(f'{m:.1f}' for m in rerank_ms)}), on {smi}; card vs CPU f32 "
            f"logits on query 0: max|d| {lerr:.4g} (limit {LOGIT_ABS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's rerank logits disagree with the CPU's f32 plain path")
        out["rerank"] = {"ms_median": statistics.median(rerank_ms), "ms": rerank_ms,
                         "max_abs_logit": lerr}
        del stores, corpus, filler
        gc.collect()

        # 6. over HTTP beside a decoding engine A
        out["http"] = _retrieval_http(dev, emb, rng, smi)
    finally:
        if not keep or sys.exc_info()[0] is not None:
            emb.close()
            rr.close()
    log(f"phase retrieval: ok ({time.time() - t0:.1f} s)")
    return out, ((emb, rr) if keep else None)


def _retrieval_http(dev, emb, rng, smi) -> dict:
    """Engine A's weights behind the server with ``emb``: /v1/embeddings
    and /v1/models, then an ingest of 64 passages and three embed_query
    calls while 8 greedy requests decode, counting each thread's
    synchronizing calls."""
    import numpy as np

    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    engine = LLMEngine(EngineConfig(model_config_name=MODEL, quantization="int8",
                                    kv_cache_dtype="bfloat16", kv_layout="paged",
                                    tensor_parallelism=1), device=dev)
    server = make_server("127.0.0.1", 0, engine=engine, embedder=emb)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http-retrieval", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        texts = _texts(rng, 3, 40, 200)
        status, text = _post(base, "/v1/embeddings", {"input": texts})
        body = json.loads(text)
        vecs = np.asarray([d["embedding"] for d in body["data"]], np.float32)
        direct = emb.embed_documents(texts)
        cos, err, same = _row_stats(vecs, direct)
        norms = np.linalg.norm(vecs, axis=1)
        ok = (status == 200 and vecs.shape == (3, emb.dimensions) and np.abs(norms - 1).max() <= 1e-5
              and (same == 3 or (cos >= SAME_DEVICE_COS and err <= SAME_DEVICE_ABS)))
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as resp:
            models = [m["id"] for m in json.loads(resp.read())["data"]]
        log(f"  POST /v1/embeddings (3 inputs): HTTP {status}, {vecs.shape[1]} dims, norms "
            f"{[round(float(n), 6) for n in norms]}, against embed_documents: {same}/3 bitwise, "
            f"max|d| {err:.3g}; /v1/models {models} {'ok' if ok else 'FAIL'}")
        if not ok or models != ["torch-llama", "torch-arctic-embed"]:
            raise AssertionError("/v1/embeddings or /v1/models is wrong")

        with llm_engine._ENGINE_LOCK:
            llm_engine._ENGINE = engine  # the process engine the ingest gate asks
        try:
            gate0 = dict(emb._batcher.counters)
            with SyncCounter() as syncs:
                prompts = [[256] + [(5 * i + j) % 250 for j in range(90 + 9 * i)] for i in range(8)]
                queues = [engine.generate_ids(p, SamplingParams(temperature=0.0, max_tokens=64))
                          for p in prompts]
                deadline = time.time() + 120
                while not engine.is_decoding() and time.time() < deadline:
                    time.sleep(0.005)
                ingest = {}
                passages = _texts(rng, 64, 32, 512)

                def run_ingest():
                    t1 = time.perf_counter()
                    ingest["vecs"] = emb.embed_documents(passages)
                    ingest["s"] = time.perf_counter() - t1

                th = threading.Thread(target=run_ingest, name="smoke-ingest", daemon=True)
                th.start()
                query_ms, while_decoding = [], []
                for i in range(3):
                    emb.clear_query_cache()
                    t1 = time.perf_counter()
                    emb.embed_query(f"a live question number {i} about the corpus")
                    query_ms.append((time.perf_counter() - t1) * 1e3)
                    while_decoding.append(engine.is_decoding())
                th.join(600)
                n_ids = [len(_drain_ids(q)) for q in queues]
        finally:
            with llm_engine._ENGINE_LOCK:
                llm_engine._ENGINE = None
        counters = emb._batcher.counters
        gated = counters["ingest_gated_batches"] - gate0.get("ingest_gated_batches", 0)
        waited = counters["ingest_gate_wait_s"] - gate0.get("ingest_gate_wait_s", 0.0)
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        log(f"  while 8 greedy requests decoded ({n_ids} ids): an ingest of 64 passages (2 "
            f"batches) took {ingest.get('s', float('nan')):.3f} s and waited on ingest_window "
            f"{gated} times (a batch a query preempted waits again), {waited * 1e3:.1f} ms in "
            f"all; 3 embed_query calls "
            f"{[round(m, 2) for m in query_ms]} ms (engine decoding at each return: "
            f"{while_decoding}; the query lane has no gate); synchronizing calls by thread: "
            f"{dict(syncs.counts)} on {smi}")
        if "vecs" not in ingest or ingest["vecs"].shape != (64, emb.dimensions):
            raise AssertionError("the ingest during decode did not finish")
        if gated < 1:
            raise AssertionError("no ingest batch waited on ingest_window while the engine decoded")
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while embeddings ran")
        return {"status": status, "ingest_s": ingest["s"], "ingest_gated_batches": gated,
                "ingest_gate_wait_ms": waited * 1e3, "query_ms": query_ms,
                "query_while_decoding": while_decoding, "dispatch_syncs": dispatch_syncs,
                "syncs_by_thread": dict(syncs.counts)}
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# Phase 7: developer_rag end to end through the chain server

RAG_DOCS, RAG_QUERIES, RAG_WORDS = 16, 8, 24
# The phase's deployment, read through the JAX config's APP_* names by the
# port's own factories (config.get_config, chains.runtime, create_llm,
# create_embedder, create_reranker). Two values differ from the JAX defaults,
# both because the encoders' weights are random:
# - APP_RETRIEVER_SCORETHRESHOLD=1.0: a random arctic-embed-l's cosine says
#   nothing of relevance, so no dense hit passes (a clamped cosine of two
#   different texts stays below 1.0); the dense leg still embeds every query
#   and searches the store on the card, and BM25 over per-document
#   vocabularies gives the candidates: exactly the chunks of the document a
#   query sentence was taken from;
# - APP_TEXTSPLITTER_CHUNKSIZE=48, CHUNKOVERLAP=16 (JAX: 510, 200 words): a
#   document of 100-150 words then makes 4-5 chunks, so each query has
#   several candidates and the random arctic-embed-m reranker orders them
#   (at 510 words a document is one chunk, and one candidate is never
#   reranked). Its order is arbitrary but held against the CPU's f32.
RAG_ENV = {
    "EXAMPLE_NAME": "developer_rag",
    "APP_LLM_MODELENGINE": "tpu",
    "APP_EMBEDDINGS_MODELENGINE": "tpu",
    "APP_RANKING_MODELENGINE": "tpu",
    "APP_ENGINE_MODELCONFIGNAME": MODEL,
    "APP_ENGINE_QUANTIZATION": "int8",
    "APP_ENGINE_KVCACHEDTYPE": "bfloat16",
    "APP_ENGINE_KVLAYOUT": "paged",
    "APP_ENGINE_TENSORPARALLELISM": "1",
    "APP_RETRIEVER_NRPIPELINE": "ranked_hybrid",
    "APP_RETRIEVER_SCORETHRESHOLD": "1.0",
    "APP_TEXTSPLITTER_CHUNKSIZE": "48",
    "APP_TEXTSPLITTER_CHUNKOVERLAP": "16",
}
RAG_EXPECTED = ("int8_matmul", "paged_attention[bfloat16]", "flash_attention_causal")
# phase 8's split topology: api_catalog answering through RemoteLLMBackend
# (APP_LLM_SERVERURL is the engine server's address, known once it listens)
REMOTE_LLM_ENV = {"EXAMPLE_NAME": "api_catalog", "APP_LLM_MODELENGINE": "remote"}


def _rag_corpus(rng):
    """RAG_DOCS documents of 100-150 words, each from its own vocabulary of
    RAG_WORDS seeded pseudo-words, as lists of sentences (8-12 words, a
    period each)."""
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = set()
    while len(words) < RAG_DOCS * RAG_WORDS:
        words.add("".join(rng.choice(letters, int(rng.randint(4, 10)))))
    words = sorted(words)
    rng.shuffle(words)
    docs = []
    for d in range(RAG_DOCS):
        vocab = words[d * RAG_WORDS:(d + 1) * RAG_WORDS]
        target, sentences, n = int(rng.randint(100, 151)), [], 0
        while n < target:
            k = min(int(rng.randint(8, 13)), target - n) if target - n >= 8 else target - n
            sentences.append(" ".join(rng.choice(vocab, k)) + ".")
            n += k
        docs.append(sentences)
    return docs


def _rag_files(docs):
    """(filename, bytes) per document: 13 .txt, 2 .md and 1 .pdf."""
    from generativeaiexamples_tpu_torch.retrieval.pdf import write_text_pdf

    files = []
    for d, sentences in enumerate(docs):
        if d == RAG_DOCS - 1:
            files.append((f"doc{d:02d}.pdf", write_text_pdf(sentences)))
        elif d >= RAG_DOCS - 3:
            body = f"# Notes {d}\n\n" + " ".join(sentences[:3]) + "\n\n" + " ".join(sentences[3:])
            files.append((f"doc{d:02d}.md", body.encode()))
        else:
            files.append((f"doc{d:02d}.txt", " ".join(sentences).encode()))
    return files


def _multipart(filename, data):
    boundary = "chipsmokeboundary7"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
    return body + data + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _http(base, method, path, body=None, raw=None, ctype="application/json", timeout=600):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _generate_stream(base, query, kb, max_tokens=64, history=(), temperature=None,
                     headers=None):
    """One streamed /generate, ``history`` (role, content) pairs before the
    query, ``headers`` added to the request: (frames, seconds to the first
    answer frame (the [DONE] frame when no text came), seconds to the
    end)."""
    messages = [{"role": r, "content": c} for r, c in history]
    body = {"messages": messages + [{"role": "user", "content": query}],
            "use_knowledge_base": kb, "max_tokens": max_tokens}
    if temperature is not None:
        body["temperature"] = temperature
    req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    frames, first = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"/generate: HTTP {resp.status}")
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if not line:
                continue
            if not line.startswith("data: "):
                raise AssertionError(f"/generate: not an SSE data line: {line[:80]!r}")
            frame = json.loads(line[6:])
            frames.append(frame)
            choice = (frame.get("choices") or [{}])[0]
            if first is None and (choice.get("message", {}).get("content")
                                  or choice.get("finish_reason") == "[DONE]"):
                first = time.perf_counter() - t0
    return frames, first, time.perf_counter() - t0


class _RecordingEngine:
    """Engine A behind a recorder of the prompt ids it is handed (what the
    chain's backend renders, or the engine server's ``chat`` route); with
    ``seed``, every request samples from that seed; while ``greedy`` is
    set, every request decodes greedily (temperature 0, which the chain
    server's schema refuses: its floor is 0.1). Everything else goes to
    the engine."""

    def __init__(self, engine, seed=None):
        self._engine = engine
        self.tokenizer = engine.tokenizer
        self.seed = seed
        self.greedy = False
        self.prompts = []
        self._lock = threading.Lock()

    def stream_text(self, prompt_ids, params=None, timeout=None):
        if self.seed is not None:
            params = dataclasses.replace(params, seed=self.seed)
        if self.greedy:
            params = dataclasses.replace(params, temperature=0.0)
        with self._lock:
            self.prompts.append(list(prompt_ids))
        return self._engine.stream_text(prompt_ids, params, timeout=timeout)

    def chat(self, messages, params=None):
        return self.stream_text(self.tokenizer.render_chat(messages), params)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _prefix_counts(before, after) -> dict:
    """The prefix cache's hits and misses between two ``engine.stats()``
    (the chains' preambles are shorter than a prefill chunk: few hits)."""
    return {k: after.get("prefix_cache_" + k, 0) - before.get("prefix_cache_" + k, 0)
            for k in ("hits", "misses")}


def _rag_deploy(encoders=None) -> dict:
    """Phase 7's deployment (``RAG_ENV``) under a temporary store and
    upload directory, built by the port's factories: the embedder and the
    reranker (``encoders``, phase 6's pair, put in the factories' caches
    instead of building a second pair) and engine A through ``create_llm``.
    ``_rag_teardown`` undoes it."""
    import os
    import tempfile

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import embedder as emb_mod
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine import reranker as rr_mod
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rag_")
    env = dict(RAG_ENV, APP_VECTORSTORE_PERSISTDIR=os.path.join(tmp, "store"),
               DOC_UPLOAD_DIR=os.path.join(tmp, "uploads"))
    dep = {"tmp": tmp, "saved_env": {k: os.environ.get(k) for k in
                                     list(env) + ["APP_LLM_SERVERURL"]}}
    os.environ.update(env)
    runtime.reset_runtime()
    runtime.set_device(None)
    try:
        config = config_mod.get_config()
        dep["emb_key"] = (config.embeddings.model_engine, config.embeddings.server_url,
                          config.embeddings.model_name, "None")
        dep["rr_key"] = (config.ranking.model_engine, config.ranking.server_url,
                         config.ranking.model_name, "None")
        if encoders is not None:  # phase 6's pair: the same models, seed and batching
            emb_mod._EMBEDDER_CACHE[dep["emb_key"]], rr_mod._RERANKER_CACHE[dep["rr_key"]] = \
                encoders
        emb, rr = runtime.get_embedder(config), runtime.resolve_pipeline(config, 4)[2]
        if not isinstance(emb, TorchEmbedder) or not isinstance(rr, TorchReranker):
            raise AssertionError(f"the factories built {type(emb).__name__}, {type(rr).__name__}")
        if emb._params["tok_embed"].device.type != "cuda" or rr._head["w"].device.type != "cuda":
            raise AssertionError("the embedder or the reranker is off the card")
        t1 = time.time()
        engine = runtime.get_llm(config)._engine
        if engine is not llm_engine._ENGINE or engine.device.type != "cuda" or not engine._paged:
            raise AssertionError("create_llm did not build the process engine on the card, paged")
    except BaseException:
        _rag_teardown(dep)
        raise
    dep.update(config=config, emb=emb, rr=rr, engine=engine, engine_s=time.time() - t1)
    return dep


def _rag_teardown(dep) -> None:
    """Shut engine A down, close the encoders, restore the environment and
    remove the temporary directory."""
    import os
    import shutil

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import llm_engine

    eng = llm_engine._ENGINE
    if eng is not None:
        eng.shutdown()
    with llm_engine._ENGINE_LOCK:
        llm_engine._ENGINE = None
    runtime.reset_runtime()  # closes the encoders' batcher threads
    for key, value in dep["saved_env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    config_mod.get_config.cache_clear()
    shutil.rmtree(dep["tmp"], ignore_errors=True)
    for key in ("engine", "emb", "rr", "config"):  # a caller may keep ``dep``
        dep.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()


def phase_rag(dev, smi, seed=0, encoders=None, keep=False):
    """developer_rag through the port's chain server on the card (module
    docstring, phase 7). ``encoders``: phase 6's (embedder, reranker), put
    in the factories' caches instead of building a second pair. Returns the
    results and, when ``keep``, the deployment still up, its engine,
    encoders and stores, for phase 8 (else None)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.chains import developer_rag, runtime
    from generativeaiexamples_tpu_torch.config import BatchingConfig
    from generativeaiexamples_tpu_torch.engine import embedder as emb_mod
    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.engine import reranker as rr_mod
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker
    from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore
    from generativeaiexamples_tpu_torch.server.api import make_server

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    rng = np.random.RandomState(seed + 7)
    dep = _rag_deploy(encoders)
    config, emb, rr, engine = dep["config"], dep["emb"], dep["rr"], dep["engine"]
    emb_key, rr_key = dep["emb_key"], dep["rr_key"]
    server = thread = None
    out = {}
    orig_retrieve = runtime.retrieve
    try:
        recorder = _RecordingEngine(engine)
        llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
        llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(engine=recorder)
        ec = engine.engine_config
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s): {ec.model_config_name} "
            f"{ec.quantization} weights, {ec.kv_cache_dtype} paged pool, max_batch_size "
            f"{ec.max_batch_size}, max_seq_len {ec.max_seq_len}, prefill_chunk {ec.prefill_chunk} "
            f"(random weights, seed 0); {EMBED_MODEL} and {RERANK_MODEL} "
            f"{'from phase 6' if encoders is not None else 'built by the factories'}; "
            f"nr_pipeline {config.retriever.nr_pipeline}, score_threshold "
            f"{config.retriever.score_threshold}, chunks {config.text_splitter.chunk_size}/"
            f"{config.text_splitter.chunk_overlap} words")

        retrieved = {}

        def timed_retrieve(query, *args, **kwargs):
            t = time.perf_counter()
            hits = orig_retrieve(query, *args, **kwargs)
            retrieved[query] = (hits, (time.perf_counter() - t) * 1e3)
            return hits

        runtime.retrieve = timed_retrieve
        server = make_server("127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, name="smoke-chain-server",
                                  daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, text = _http(base, "GET", "/health")
        if status != 200 or json.loads(text) != {"message": "Service is up."}:
            raise AssertionError(f"/health: {status} {text}")

        # 1-2. ingest 16 documents, list them
        docs = _rag_corpus(rng)
        files = _rag_files(docs)
        ingest_s = []
        for name, data in files:
            raw, ctype = _multipart(name, data)
            t1 = time.perf_counter()
            status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
            ingest_s.append(time.perf_counter() - t1)
            if status != 200 or json.loads(text) != {"message": "File uploaded successfully"}:
                raise AssertionError(f"POST /documents {name}: {status} {text}")
        status, text = _http(base, "GET", "/documents")
        listed = json.loads(text)["documents"]
        names = [n for n, _ in files]
        if status != 200 or sorted(listed) != sorted(names):
            raise AssertionError(f"GET /documents: {status} {listed}")
        n_chunks = runtime.get_vector_store("default").count()
        if runtime.get_bm25_index("default").count() != n_chunks:
            raise AssertionError("the store and BM25 hold different chunk counts")
        note(f"ingest over POST /documents: {len(files)} documents (13 .txt, 2 .md, 1 .pdf; "
            f"{sum(len(' '.join(d).split()) for d in docs)} words) -> {n_chunks} chunks, "
            f"{statistics.mean(ingest_s):.3f} s a document (max {max(ingest_s):.3f}); "
            f"GET /documents lists the 16 on {smi}")

        # 3. /search: the first hit is the query's document; the top 4 on the
        # card against the port's runtime on the CPU in f32 (same store, loaded
        # from its persisted files, and the same BM25 index)
        picks = [int(k) for k in rng.choice(RAG_DOCS, RAG_QUERIES, replace=False)]
        searches, search_ms = [], []
        for k in picks:
            query = docs[k][0]
            t1 = time.perf_counter()
            status, text = _http(base, "POST", "/search", {"query": query, "top_k": 4})
            search_ms.append((time.perf_counter() - t1) * 1e3)
            chunks = json.loads(text)["chunks"] if status == 200 else None
            if not chunks or chunks[0]["filename"] != names[k]:
                raise AssertionError(f"/search for a sentence of {names[k]}: {status} {text[:300]}")
            searches.append((k, query, chunks))
        cpu_emb = TorchEmbedder(model_name=EMBED_MODEL, device="cpu", params=_cpu_f32(emb._params),
                                dtype=torch.float32, batching=BatchingConfig(enable="off"))
        cpu_rr = TorchReranker(model_name=RERANK_MODEL, device="cpu", params=_cpu_f32(rr._params),
                               head={k: v.to("cpu", torch.float32) for k, v in rr._head.items()},
                               dtype=torch.float32, batching=BatchingConfig(enable="off"))
        cpu_logits = {}  # (query, passages) -> the CPU's logits, kept for the tie check
        cpu_score = cpu_rr.score

        def kept_score(query, passages):
            key = (query, tuple(passages))
            if key not in cpu_logits:
                cpu_logits[key] = cpu_score(query, passages)
            return cpu_logits[key]

        cpu_rr.score = kept_score
        cpu_store = TorchVectorStore(emb.dimensions, persist_dir=config.vector_store.persist_dir,
                                     device="cpu")
        card_store = runtime._STORES["default"]
        cpu_keys = (emb_key[:3] + ("cpu",), rr_key[:3] + ("cpu",))
        emb_mod._EMBEDDER_CACHE[cpu_keys[0]], rr_mod._RERANKER_CACHE[cpu_keys[1]] = cpu_emb, cpu_rr
        try:
            runtime._STORES["default"] = cpu_store
            runtime.set_device("cpu")
            wants = [orig_retrieve(query, top_k=4) for _, query, _ in searches]
            # the reranker's logits on the card against the CPU's, pair by pair
            logit_err = max((float(np.abs(rr.score(q, list(passages)) - want).max())
                             for (q, passages), want in cpu_logits.items()), default=0.0)
        finally:
            runtime._STORES["default"] = card_store
            runtime.set_device(None)
            emb_mod._EMBEDDER_CACHE.pop(cpu_keys[0])
            rr_mod._RERANKER_CACHE.pop(cpu_keys[1])
            cpu_emb.close()
            cpu_rr.close()
        if logit_err > LOGIT_ABS:
            raise AssertionError(f"rerank logits on the card differ from the CPU's f32 by "
                                 f"{logit_err:.4g} (limit {LOGIT_ABS})")
        # where the orders differ, the card's must still follow the CPU's
        # logits up to twice the largest card-vs-CPU difference: each pair in
        # the card's order, and each candidate it cut against its last one
        tie_tol, ties = 2 * logit_err, 0
        for (k, query, chunks), want in zip(searches, wants):
            got = [c["content"] for c in chunks]
            if got == [h.chunk.text for h in want] and \
                    [c["filename"] for c in chunks] == [h.chunk.source for h in want]:
                continue
            scored = [(p, v) for (q, p), v in cpu_logits.items() if q == query]
            if not scored:  # no rerank ran: nothing may differ
                raise AssertionError(f"/search top 4 on the card for {names[k]} != CPU f32")
            cpu = dict(zip(*scored[0]))
            if any(t not in cpu for t in got) or any(
                    cpu[got[i]] < cpu[got[j]] - tie_tol
                    for i in range(len(got)) for j in range(i + 1, len(got))) or any(
                    v > cpu[got[-1]] + tie_tol for t, v in cpu.items() if t not in got):
                raise AssertionError(f"/search top 4 on the card for {names[k]} breaks the CPU's "
                                     f"rerank order beyond {tie_tol:.4g}")
            ties += 1
        note(f"POST /search x{RAG_QUERIES} (a sentence of each document, top_k 4): the first hit "
            f"is that document every time; the top 4 chunks equal the port's runtime on the CPU "
            f"in f32 ({ties} differ only inside a rerank near-tie of {tie_tol:.4g}: the card's "
            f"rerank logits are within {logit_err:.4g} of the CPU's, limit {LOGIT_ABS}); "
            f"{statistics.median(search_ms):.1f} ms p50, {max(search_ms):.1f} ms max on {smi}")

        # 4. concurrent /generate: 8 over the knowledge base and one without
        warm = _generate_stream(base, docs[picks[0]][2], True, max_tokens=8)
        if warm[0][-1]["choices"][0]["finish_reason"] != "[DONE]":
            raise AssertionError("the warm-up /generate did not end in [DONE]")

        def round_of(sentence_idx, profiled=False):
            results, errors = {}, []

            def call(name, query, kb):
                try:
                    results[name] = (query, kb) + _generate_stream(base, query, kb)
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(f"{name}: {exc!r}")

            calls = [(f"kb{i}", docs[k][sentence_idx], True) for i, k in enumerate(picks)]
            calls.append(("plain", "Say something about a graphics card.", False))
            threads = [threading.Thread(target=call, args=c, name=f"smoke-rag-{c[0]}", daemon=True)
                       for c in calls]
            t1 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t1
            if errors or len(results) != len(calls):
                raise AssertionError(f"/generate round: {errors}")
            return results, wall

        recorder.prompts.clear()
        retrieved.clear()
        reset_counts()
        before = engine.stats()
        with SyncCounter() as syncs:
            results, wall = round_of(1)
        launched = counts()
        after = engine.stats()
        bad = {developer_rag.NO_CONTEXT_MSG, developer_rag.NO_DOCS_MSG}
        ttft, retr_ms, prompt_ids, n_tokens = [], [], [], 0
        for name, (query, kb, frames, first, total) in results.items():
            if not frames or frames[-1]["choices"][0]["finish_reason"] != "[DONE]":
                raise AssertionError(f"/generate {name} does not end in [DONE]")
            answer = "".join(f["choices"][0]["message"]["content"] for f in frames[:-1]
                             if f.get("choices"))
            if answer.strip() in bad:
                raise AssertionError(f"/generate {name} answered {answer!r}")
            ttft.append(first)
            if not kb:
                continue
            hits, ms = retrieved[query]
            retr_ms.append(ms)
            top = hits[0].chunk.text
            mine = [p for p in recorder.prompts if query in engine.tokenizer.decode(p)]
            if len(mine) != 1 or top not in engine.tokenizer.decode(mine[0]):
                raise AssertionError(f"/generate {name}: the engine's prompt lacks the top hit")
            prompt_ids.append(len(mine[0]))
        if len(recorder.prompts) != len(results):
            raise AssertionError(f"{len(recorder.prompts)} prompts reached the engine for "
                                 f"{len(results)} requests")
        missing = [n for n in RAG_EXPECTED if launched[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched under /generate: {missing}")
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while retrieval ran on request threads")
        d_rows = after["decode_rows"] - before.get("decode_rows", 0)
        d_time = after["decode_time_s"] - before.get("decode_time_s", 0.0)
        out.update({
            "ingest_s_per_doc": statistics.mean(ingest_s), "ingest_s_max": max(ingest_s),
            "chunks": n_chunks, "search_ms_p50": statistics.median(search_ms),
            "search_ms_max": max(search_ms), "search_rerank_ties": ties,
            "rerank_logit_max_abs": logit_err,
            "ttft_s_mean": statistics.mean(ttft), "ttft_s_max": max(ttft),
            "retrieve_ms_mean": statistics.mean(retr_ms), "retrieve_ms_max": max(retr_ms),
            "prompt_ids_min": min(prompt_ids), "prompt_ids_max": max(prompt_ids),
            "decode_tokens_per_s": d_rows / d_time if d_time else None,
            "round_s": wall, "launches": launched, "dispatch_syncs": dispatch_syncs,
            "syncs_by_thread": dict(syncs.counts), "prefix_cache": _prefix_counts(before, after),
        })
        note(f"prefix cache (JAX default, auto) over the round: {out['prefix_cache']['hits']} hits, "
             f"{out['prefix_cache']['misses']} misses")
        note(f"/generate x{len(results)} concurrent (8 over the knowledge base, 1 without; "
            f"max_tokens 64): every stream ends in [DONE], none is a no-context answer, each "
            f"engine prompt holds its top hit's text; prompts {min(prompt_ids)}-"
            f"{max(prompt_ids)} ids (prefill_chunk {ec.prefill_chunk}); TTFT (sent -> first "
            f"answer frame) mean {out['ttft_s_mean']:.3f} s, max {out['ttft_s_max']:.3f} s, of "
            f"which retrieval (runtime.retrieve) mean {out['retrieve_ms_mean']:.1f} ms, max "
            f"{out['retrieve_ms_max']:.1f} ms; decode {out['decode_tokens_per_s'] or 0:.1f} "
            f"tokens/s (engine decode wall time), round {wall:.2f} s on {smi}")
        note(f"launches under /generate: {launched}; synchronizing calls by thread: "
            f"{dict(syncs.counts) or 'none'} (LLM dispatch thread: {dispatch_syncs})")

        # the device's idle share over a second round, traced
        from torch.profiler import ProfilerActivity, profile

        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as exc:  # noqa: BLE001 - a measurement, reported as not measured
            prof, why = None, exc
        try:
            _, wall2 = round_of(2)
            torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        out["idle_share"] = None
        if prof is not None:
            try:
                kernels = [(a, b) for _, a, b in device_trace.profile_events(prof)]
                busy = device_trace.busy_ms(kernels)
                out["idle_share"] = max(0.0, 1.0 - busy / (wall2 * 1e3))
                out["device_busy_ms"], out["traced_round_s"] = busy, wall2
                note(f"device over a second traced round ({len(kernels)} device events): busy "
                    f"{busy:.0f} ms of {wall2 * 1e3:.0f} ms, idle share {out['idle_share']:.1%} "
                    f"on {smi}")
            except Exception as exc:  # noqa: BLE001 - as above
                why = exc
        if out["idle_share"] is None:
            note(f"device idle share over /generate: not measured ({why!r})")

        # 5. delete one document from the store and BM25
        k0, q0 = searches[0][0], searches[0][1]
        n_bm25 = runtime.get_bm25_index("default").count()
        status, text = _http(base, "DELETE", f"/documents?filename={names[k0]}")
        if status != 200:
            raise AssertionError(f"DELETE /documents: {status} {text}")
        listed = json.loads(_http(base, "GET", "/documents")[1])["documents"]
        status, text = _http(base, "POST", "/search", {"query": q0, "top_k": 4})
        left = [c["filename"] for c in json.loads(text)["chunks"]]
        gone = n_bm25 - runtime.get_bm25_index("default").count()
        if names[k0] in listed or names[k0] in left or gone <= 0 or \
                runtime.get_vector_store("default").count() != n_chunks - gone:
            raise AssertionError(f"{names[k0]} is still served after DELETE: {listed}, {left}")
        note(f"DELETE /documents?filename={names[k0]}: {gone} chunks left the store and BM25; "
            f"its sentence now finds {left or 'nothing'}")

        # 6. a spent deadline
        status, text = _http(base, "POST", "/generate", {
            "messages": [{"role": "user", "content": docs[picks[1]][3]}],
            "use_knowledge_base": True, "deadline_ms": 1})
        if status != 504:
            raise AssertionError(f"/generate with deadline_ms 1: {status} {text[:200]}")
        note(f"/generate with deadline_ms 1: 504 {json.loads(text)['detail']!r}")
    finally:
        runtime.retrieve = orig_retrieve
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(60)
        if not keep or sys.exc_info()[0] is not None:
            _rag_teardown(dep)
    log(f"phase rag: ok ({time.time() - t0:.1f} s)")
    dep["corpus"] = (docs, files)
    return out, (dep if keep else None)


# --------------------------------------------------------------------- #
# Phase 8: the text chains

CHAIN_SEED = 20241  # every phase 8 engine request samples from this seed
CHAIN_CONVERSATIONS, CHAIN_TURNS = 4, 3


def _answer(frames) -> str:
    return "".join(f["choices"][0]["message"]["content"] for f in frames
                   if f.get("choices") and f["choices"][0].get("message"))


def _check_answer(what, frames, bad=()) -> str:
    """The answer of a streamed /generate: it ends in [DONE], has no
    warnings frame (a DegradedWarning) and is none of ``bad``. It may be
    empty: random weights may sample a stop token first."""
    if not frames or frames[-1]["choices"][0]["finish_reason"] != "[DONE]":
        raise AssertionError(f"{what}: the stream does not end in [DONE]")
    warned = [f["warnings"] for f in frames if f.get("warnings")]
    if warned:
        raise AssertionError(f"{what}: warnings {warned}")
    answer = _answer(frames)
    if answer.strip() in bad:
        raise AssertionError(f"{what}: answered {answer!r}")
    return answer


def _concurrently(calls) -> dict:
    """Run ``calls`` ({name: fn}) on threads of their own; their results by
    name, or the first error raised."""
    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc!r}")

    threads = [threading.Thread(target=run, args=(name, fn), name=f"smoke-{name}", daemon=True)
               for name, fn in calls.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    if errors or len(results) != len(calls):
        raise AssertionError(f"concurrent requests failed: {errors or 'timed out'}")
    return results


def phase_chains(dev, smi, seed=0, dep=None, encoders=None, keep=False):
    """The text chains through the port's chain server on the card (module
    docstring, phase 8): ``dep`` is phase 7's deployment, still up, or None
    to build one (with phase 6's ``encoders`` when given) and ingest phase
    7's corpus into ``default``. Returns the results and, when ``keep``,
    the deployment still up for phase 10 (else None)."""
    import os
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import developer_rag, multi_turn, registry, runtime
    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.engine import server as engine_server
    from generativeaiexamples_tpu_torch.server.api import make_server

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    if dep is None:
        dep = _rag_deploy_ingested(seed, encoders)
        docs, files = dep["corpus"]
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s) and {EMBED_MODEL}/"
             f"{RERANK_MODEL} {'from phase 6' if encoders is not None else 'by the factories'}; "
             f"phase 7's {len(files)} documents ingested into 'default'")
    else:
        docs, files = dep["corpus"]
        note(f"phase 7's engine A, encoders and 'default' collection "
             f"({runtime.get_vector_store('default').count()} chunks)")
    config, engine = dep["config"], dep["engine"]
    stats0 = engine.stats()
    names = [n for n, _ in files]
    # the documents 'default' still holds (phase 7 deletes one)
    present = set(runtime.get_vector_store("default").sources())
    avail = [k for k in range(RAG_DOCS) if names[k] in present]
    bad = {developer_rag.NO_CONTEXT_MSG, developer_rag.NO_DOCS_MSG}
    recorder = _RecordingEngine(engine, seed=CHAIN_SEED)
    llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
    llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(engine=recorder)
    servers, out, ttft, prompt_ids = [], {}, collections.defaultdict(list), {}

    def serve(example):
        """A chain server for ``example`` (resolved through the registry)."""
        server = make_server("127.0.0.1", 0, registry.resolve_example(example))
        thread = threading.Thread(target=server.serve_forever, name=f"smoke-{example}-server",
                                  daemon=True)
        thread.start()
        servers.append((server, thread))
        return f"http://127.0.0.1:{server.server_address[1]}"

    def prompts_with(text):
        with recorder._lock:
            return [p for p in recorder.prompts if text in engine.tokenizer.decode(p)]

    def ids_line(chain):
        return f"{min(prompt_ids[chain])}-{max(prompt_ids[chain])}"

    t_phase = time.perf_counter()
    reset_counts()
    try:
        with SyncCounter() as syncs:
            # 1. simple_rag: its own collection, 2000-character chunks
            base = serve("simple_rag")
            for name, data in files:
                raw, ctype = _multipart(name, data)
                status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
                if status != 200 or json.loads(text) != {"message": "File uploaded successfully"}:
                    raise AssertionError(f"simple_rag POST /documents {name}: {status} {text}")
            status, text = _http(base, "GET", "/documents")
            if status != 200 or sorted(json.loads(text)["documents"]) != sorted(names):
                raise AssertionError(f"simple_rag GET /documents: {status} {text[:300]}")
            n_sr = runtime.get_vector_store("simple_rag").count()
            if runtime.get_bm25_index("simple_rag").count() != n_sr:
                raise AssertionError("simple_rag: the store and BM25 hold different chunk counts")
            for k in (0, 5, 10, RAG_DOCS - 1):
                status, text = _http(base, "POST", "/search", {"query": docs[k][0], "top_k": 4})
                chunks = json.loads(text)["chunks"] if status == 200 else None
                if not chunks or chunks[0]["filename"] != names[k]:
                    raise AssertionError(f"simple_rag /search for a sentence of {names[k]}: "
                                         f"{status} {text[:300]}")
            # four concurrent questions, each of sentences from four documents
            questions = {f"sr{i}": " ".join(docs[(4 * i + j) % RAG_DOCS][1] for j in range(4))
                         for i in range(4)}
            results = _concurrently({n: (lambda q=q: _generate_stream(base, q, True))
                                     for n, q in questions.items()})
            prompt_ids["simple_rag"] = []
            for n, (frames, first, _) in results.items():
                _check_answer(f"simple_rag {n}", frames, bad)
                ttft["simple_rag"].append(first)
                mine = prompts_with(questions[n])
                if len(mine) != 1:
                    raise AssertionError(f"simple_rag {n}: {len(mine)} engine prompts")
                if len(mine[0]) >= engine.max_seq_len:
                    raise AssertionError(f"simple_rag {n}: a prompt of {len(mine[0])} ids")
                prompt_ids["simple_rag"].append(len(mine[0]))
            note(f"simple_rag: {len(files)} documents over POST /documents -> {n_sr} chunks of "
                 f"<= 2000 characters in 'simple_rag' (store and BM25); /search finds each "
                 f"query's document first; 4 concurrent /generate (4 documents' sentences each, "
                 f"max_tokens 64) answer 200 with no warning; prompts {ids_line('simple_rag')} "
                 f"ids; TTFT mean {statistics.mean(ttft['simple_rag']):.3f} s, max "
                 f"{max(ttft['simple_rag']):.3f} s on {smi}")

            # 2. multi_turn: 4 conversations x 3 turns, memory in conv_store
            base = serve("multi_turn")
            with recorder._lock:
                recorder.prompts.clear()
            convo_docs = [avail[i] for i in (1, 5, 9, 13)]

            def conversation(c):
                history, turns = [], []
                for t in range(CHAIN_TURNS):
                    query = docs[convo_docs[c]][t]
                    frames, first, _ = _generate_stream(base, query, True, history=history)
                    answer = _check_answer(f"multi_turn conversation {c} turn {t}", frames, bad)
                    turns.append((query, first))
                    history += [("user", query), ("assistant", answer)]
                return turns

            results = _concurrently({f"mt{c}": (lambda c=c: conversation(c))
                                     for c in range(CHAIN_CONVERSATIONS)})
            want = 2 * CHAIN_CONVERSATIONS * CHAIN_TURNS
            n_dense = runtime.get_vector_store(multi_turn.CONV_COLLECTION).count()
            n_bm25 = runtime.get_bm25_index(multi_turn.CONV_COLLECTION).count()
            if n_dense != want or n_bm25 != want:
                raise AssertionError(f"conv_store holds {n_dense} chunks (BM25 {n_bm25}), "
                                     f"not {want}")
            prompt_ids["multi_turn"], recalled = [], 0
            for c, turns in enumerate(results[f"mt{c}"] for c in range(CHAIN_CONVERSATIONS)):
                first_q = turns[0][0]
                hits = runtime.retrieve(first_q, collection=multi_turn.CONV_COLLECTION)
                if f"User previously responded with {first_q}" not in [h.chunk.text for h in hits]:
                    raise AssertionError(f"conversation {c}: a conv_store retrieve of its first "
                                         f"question misses its memory")
                for t, (query, first) in enumerate(turns):
                    ttft["multi_turn"].append(first)
                    mine = prompts_with("User Query: " + query)
                    if len(mine) != 1:
                        raise AssertionError(f"multi_turn {c}/{t}: {len(mine)} engine prompts")
                    prompt_ids["multi_turn"].append(len(mine[0]))
                    recalled += t > 0 and "User previously responded with" in \
                        engine.tokenizer.decode(mine[0])
            note(f"multi_turn: {CHAIN_CONVERSATIONS} concurrent conversations x {CHAIN_TURNS} "
                 f"turns (history in messages) answer 200 with no warning; conv_store holds "
                 f"{n_dense} chunks in the store and BM25; each first question retrieves its "
                 f"'User previously responded with ...' memory; {recalled} of "
                 f"{CHAIN_CONVERSATIONS * (CHAIN_TURNS - 1)} later turns' prompts held a memory; "
                 f"prompts {ids_line('multi_turn')} ids; TTFT mean "
                 f"{statistics.mean(ttft['multi_turn']):.3f} s, max "
                 f"{max(ttft['multi_turn']):.3f} s on {smi}")

            # 3. query_decomposition: 2 concurrent answers, >= 3 engine requests each
            base = serve("query_decomposition")
            questions = {f"qd{i}": docs[avail[j]][2] for i, j in enumerate((3, 7))}
            with recorder._lock:
                recorder.prompts.clear()
            before = engine.stats()["requests_prefilled"]
            results = _concurrently({n: (lambda q=q: _generate_stream(base, q, True))
                                     for n, q in questions.items()})
            per_answer = (engine.stats()["requests_prefilled"] - before) / len(questions)
            prompt_ids["query_decomposition"], qd_requests = [], []
            for n, (frames, first, _) in results.items():
                _check_answer(f"query_decomposition {n}", frames, bad)
                ttft["query_decomposition"].append(first)
                # the decomposition, extract and final prompts quote the question
                mine = prompts_with("Question:\n" + questions[n]) + \
                    prompts_with("Question: " + questions[n])
                qd_requests.append(len(mine))
                prompt_ids["query_decomposition"] += [len(p) for p in mine]
            if per_answer < 3 or min(qd_requests) < 3:
                raise AssertionError(f"query_decomposition: {per_answer} engine requests an "
                                     f"answer ({qd_requests} prompts hold each question)")
            note(f"query_decomposition: 2 concurrent /generate answer 200 with no warning; "
                 f"{per_answer:.1f} engine requests an answer (engine stats; prompts holding "
                 f"each question: {qd_requests}: decomposition, extract, final); prompts "
                 f"{ids_line('query_decomposition')} ids; TTFT mean "
                 f"{statistics.mean(ttft['query_decomposition']):.3f} s, max "
                 f"{max(ttft['query_decomposition']):.3f} s on {smi}")

            # 4. api_catalog in process, then through the engine server
            query = docs[avail[11]][1]
            legs = {}
            eng_server = engine_server.make_server("127.0.0.1", 0, engine=recorder)
            eng_thread = threading.Thread(target=eng_server.serve_forever,
                                          name="smoke-engine-server", daemon=True)
            eng_thread.start()
            servers.append((eng_server, eng_thread))
            remote_env = dict(REMOTE_LLM_ENV, APP_LLM_SERVERURL=(
                f"http://127.0.0.1:{eng_server.server_address[1]}"))
            for leg in ("in-process", "remote"):
                if leg == "remote":  # _rag_teardown restores the environment
                    os.environ.update(remote_env)
                    config_mod.get_config.cache_clear()
                with recorder._lock:
                    recorder.prompts.clear()
                base = serve("api_catalog")
                frames, first, _ = _generate_stream(base, query, True)
                legs[leg] = (_check_answer(f"api_catalog {leg}", frames, bad),
                             [list(p) for p in recorder.prompts])
                ttft["api_catalog"].append(first)
                if len(legs[leg][1]) != 1:
                    raise AssertionError(f"api_catalog {leg}: {len(legs[leg][1])} engine prompts")
            backend = runtime.get_llm()
            if type(backend).__name__ != "RemoteLLMBackend":
                raise AssertionError(f"api_catalog's remote leg answered through "
                                     f"{type(backend).__name__}")
            if legs["remote"][1] != legs["in-process"][1]:
                raise AssertionError("api_catalog: the engine got other prompt ids through the "
                                     "engine server than through the in-process backend")
            if legs["remote"][0] != legs["in-process"][0]:
                raise AssertionError(f"api_catalog: the remote stream {legs['remote'][0]!r} "
                                     f"differs from the in-process one {legs['in-process'][0]!r}")
            prompt_ids["api_catalog"] = [len(legs["remote"][1][0])]
            note(f"api_catalog: one /generate in process, then the same through "
                 f"RemoteLLMBackend -> the engine server -> engine A: the same "
                 f"{prompt_ids['api_catalog'][0]} prompt ids and the same "
                 f"{len(legs['remote'][0])}-character answer (seed {CHAIN_SEED}); TTFT "
                 f"{ttft['api_catalog'][0]:.3f} s in process, {ttft['api_catalog'][1]:.3f} s "
                 f"remote on {smi}")
        launched = counts()
        wall = time.perf_counter() - t_phase
        missing = [n for n in RAG_EXPECTED if launched[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched by the chains: {missing}")
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while the chains ran")
        out.update({
            "ttft_s": {c: {"mean": statistics.mean(v), "max": max(v)} for c, v in ttft.items()},
            "prompt_ids": {c: [min(v), max(v)] for c, v in prompt_ids.items()},
            "qd_engine_requests_per_answer": per_answer, "simple_rag_chunks": n_sr,
            "conv_store_chunks": n_dense, "launches": launched, "dispatch_syncs": dispatch_syncs,
            "syncs_by_thread": dict(syncs.counts), "wall_s": wall,
            "prefix_cache": _prefix_counts(stats0, engine.stats()),
        })
        note(f"prefix cache (JAX default, auto) over the phase: {out['prefix_cache']['hits']} "
             f"hits, {out['prefix_cache']['misses']} misses")
        note(f"launches in the phase: " + ", ".join(f"{n} {launched[n]}" for n in RAG_EXPECTED)
             + f"; synchronizing calls by thread: {dict(syncs.counts) or 'none'} (LLM dispatch "
             f"thread: {dispatch_syncs}); phase wall {wall:.1f} s on {smi}")
    finally:
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(60)
        if not keep or sys.exc_info()[0] is not None:
            _rag_teardown(dep)
    log(f"phase chains: ok ({time.time() - t0:.1f} s)")
    return out, (dep if keep else None)


# --------------------------------------------------------------------- #
# Phase 9: the automatic prefix KV cache

# the JAX bench's shared-prefix pass (bench.py): one preamble of
# PREFIX_CHUNKS prefill chunks, PREFIX_QUESTIONS distinct questions of
# PREFIX_QUESTION_IDS ids after it, PREFIX_TOKENS greedy tokens each, one
# request at a time
PREFIX_CHUNKS, PREFIX_QUESTIONS, PREFIX_QUESTION_IDS, PREFIX_TOKENS = 4, 16, 128, 16
PREFIX_RECIPES = "AD"  # the bf16 paged pool (shared pages) and the int8 fixed store (copies)
# D runs at 8 of llama3-8b's 32 layers (full width), for the script's time
# once phase 14 joined it, and A too once phase 20 did
PREFIX_CUT_RECIPES, PREFIX_CUT_LAYERS = "AD", CUT_LAYERS


def _prefix_stream(engine, prompt, params):
    """One request alone: (stream, TTFT s, prefill chunks it dispatched)."""
    c0 = engine.stats()["prefill_chunks"]
    t0 = time.perf_counter()
    q = engine.generate_ids(prompt, params)
    first = q.get(timeout=600)
    ttft = time.perf_counter() - t0
    stream = [] if first is None else [first] + _drain_ids(q)
    return stream, ttft, engine.stats()["prefill_chunks"] - c0


def _settle(engine, timeout=60.0) -> None:
    """Wait until the dispatch thread has released every slot."""
    deadline = time.time() + timeout
    while engine._slot_req and time.time() < deadline:
        time.sleep(0.01)
    if engine._slot_req:
        raise AssertionError("slots still held after every stream ended")


def _last_logits(engine, ids):
    """The logits after ``ids``, prefilled chunk by chunk through the model
    functions over a page pool of their own (the margin of a cold
    reference's token)."""
    from generativeaiexamples_tpu_torch.models import llama

    cfg, dev, ec = engine.model_config, engine.device, engine.engine_config
    C, page = ec.prefill_chunk, ec.page_size
    n_chunks = -(-len(ids) // C)
    pmax = engine._attention_window(n_chunks * C) // page
    pool = llama.init_kv_pool(cfg, 1 + pmax, page, torch.bfloat16, dev, quantized=engine._kv_quant,
                              tp=engine._tp)
    tables = torch.arange(1, 1 + pmax, dtype=torch.int32, device=dev)[None]
    for k in range(n_chunks):
        seg = ids[k * C:(k + 1) * C]
        h, _ = llama.extend_layers_paged(
            engine.params, cfg, torch.tensor([seg + [0] * (C - len(seg))], device=dev),
            torch.tensor([k * C], device=dev), torch.tensor([len(seg)], device=dev),
            torch.tensor([0], device=dev), tables, pool,
            engine._attention_window(min((k + 1) * C, engine.max_seq_len)), page,
            quant_kernel=engine._quant_kernel, tp=engine._tp)
    return llama._head(engine.params, h[:, None, :], cfg, engine._quant_kernel,
                       engine._tp)[0, 0, : engine._sample_vocab]


def _tie_checked(engine, label, prompt, got, want) -> int:
    """``got`` equals its cold reference ``want``, or the two part at a
    token whose top-1 margin in the reference's logits is within
    LOGITS_TOL (a random-init tie; after it the contexts differ). Returns
    1 for a tie, 0 for equal streams."""
    if got == want:
        return 0
    at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    top2 = torch.topk(_last_logits(engine, prompt + want[:at]).float(), 2).values
    margin = float(top2[0] - top2[1])
    log(f"    {label}: parts from its cold reference at token {at} (got "
        f"{got[at] if at < len(got) else 'the end'}, cold {want[at] if at < len(want) else 'the end'}), "
        f"where the cold top-1 margin is {margin:.4g} (tolerance {LOGITS_TOL})")
    if margin > LOGITS_TOL:
        raise AssertionError(f"{label}: the warm engine's stream differs from the cold one "
                             f"beyond a tie (margin {margin:.4g} > {LOGITS_TOL})")
    return 1


def prefix_recipe(dev, smi, name, quantization, kv_dtype, layout, expected, seed,
                  model=MODEL) -> dict:
    """One recipe's shared-prefix pass: a cache-off engine gives the cold
    streams, then an engine at the JAX default (``prefix_cache_enable``
    auto, 4 slots) on the same weights gives the warm ones; the two are
    built one after the other."""
    import random

    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams

    rng = random.Random(seed * 1000 + ord(name))
    base = EngineConfig(model_config_name=model, quantization=quantization,
                        kv_cache_dtype=kv_dtype, kv_layout=layout, tensor_parallelism=1)
    C = base.prefill_chunk
    preamble = [256] + [rng.randrange(1, 256) for _ in range(PREFIX_CHUNKS * C - 1)]
    prompts = [preamble + [rng.randrange(1, 256) for _ in range(PREFIX_QUESTION_IDS)]
               for _ in range(PREFIX_QUESTIONS)]
    # the mixed wave: a warm row (the preamble and a new question), a cold
    # 1.5k-id row and a 300-id row (one chunk: the flash kernel)
    wave = [preamble + [rng.randrange(1, 256) for _ in range(PREFIX_QUESTION_IDS)],
            [256] + [rng.randrange(1, 256) for _ in range(1499)],
            [256] + [rng.randrange(1, 256) for _ in range(299)]]
    params = SamplingParams(temperature=0.0, max_tokens=PREFIX_TOKENS)
    out = {"prompt_ids": len(prompts[0]), "preamble_ids": len(preamble)}

    t0 = time.time()
    cold = LLMEngine(dataclasses.replace(base, prefix_cache_enable="off"), device=dev)
    weights = cold.params
    try:
        if cold._prefix is not None or cold._paged != (layout == "paged"):
            raise AssertionError(f"{name}: the cache-off engine is not the one asked for")
        cold_runs = [_prefix_stream(cold, p, params) for p in prompts]
        wave_refs = [_prefix_stream(cold, p, params)[0] for p in wave]
    finally:
        cold.shutdown()
        del cold
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  {name}: cold engine (prefix_cache_enable off) served {PREFIX_QUESTIONS} requests "
        f"of {out['prompt_ids']} ids ({time.time() - t0:.1f} s with its build)")

    t1 = time.time()
    warm = LLMEngine(base, device=dev, params=weights)
    try:
        if warm._prefix is None or warm._paged != (layout == "paged"):
            raise AssertionError(f"{name}: the JAX default built no prefix cache")
        cache_bytes = warm.prefix_cache_bytes()
        if warm._paged:
            mem = (f"pool {warm._pool_pages} pages x {base.page_size} "
                   f"({sum(t.numel() * t.element_size() for c in warm._cache for t in c.values()) / 2**30:.2f} GiB), "
                   f"{cache_bytes / 2**30:.2f} GiB of it the {base.prefix_cache_slots} entries' strips")
        else:
            mem = (f"store {base.prefix_cache_slots} slots x {warm.max_seq_len} rows "
                   f"{kv_dtype} ({cache_bytes / 2**30:.2f} GiB)")
        log(f"  {name}: warm engine (prefix_cache_enable auto, {base.prefix_cache_slots} slots): {mem}")
        reset_counts()
        snap = None
        with SyncCounter() as syncs:
            warm_runs = [_prefix_stream(warm, prompts[0], params)]
            if warm._paged:  # the donor's pages, right after its insert
                (entry,) = warm._prefix._entries
                snap = (list(entry.pages),
                        [{k: t[entry.pages].clone() for k, t in c.items()} for c in warm._cache])
            warm_runs += [_prefix_stream(warm, p, params) for p in prompts[1:]]
            _settle(warm)
            st = warm.stats()
            with warm.hold_admissions():
                reqs = [warm.submit(p, params) for p in wave]
            wave_out = [_drain_ids(r.out_queue) for r in reqs]
            _settle(warm)
        launched = counts()
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        end = warm.stats()

        # identity, hits and chunks
        mismatched = [i for i, ((a, _, _), (b, _, _)) in enumerate(zip(warm_runs, cold_runs)) if a != b]
        if mismatched:
            raise AssertionError(f"{name}: warm streams {mismatched} differ from their cold streams")
        cold_chunks = [c for _, _, c in cold_runs]
        warm_chunks = [c for _, _, c in warm_runs]
        n_chunks = -(-out["prompt_ids"] // C)
        hits, misses = st["prefix_cache_hits"], st["prefix_cache_misses"]
        if cold_chunks != [n_chunks] * PREFIX_QUESTIONS or \
                warm_chunks != [n_chunks] + [1] * (PREFIX_QUESTIONS - 1):
            raise AssertionError(f"{name}: prefill chunks cold {cold_chunks}, warm {warm_chunks}")
        if (hits, misses) != (PREFIX_QUESTIONS - 1, 1) or \
                st["prefix_cache_tokens_reused"] != (PREFIX_QUESTIONS - 1) * len(preamble):
            raise AssertionError(f"{name}: hits {hits}, misses {misses}, tokens reused "
                                 f"{st['prefix_cache_tokens_reused']}")
        pages_per_hit = len(preamble) // base.page_size
        want = ((0, (PREFIX_QUESTIONS - 1) * pages_per_hit) if warm._paged
                else (PREFIX_QUESTIONS, 0))  # fixed: 1 insert + 15 fetches
        if (st["prefix_copy_dispatches"], st["prefix_pages_mapped"]) != want:
            raise AssertionError(f"{name}: copies {st['prefix_copy_dispatches']}, pages mapped "
                                 f"{st['prefix_pages_mapped']}, expected {want}")
        if dispatch_syncs:
            raise AssertionError(f"{name}: the dispatch thread waited for the card {dispatch_syncs} times")
        missing = [n for n in expected if launched[n] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched by the prefix path: {missing}")
        if snap is not None:
            pages, before = snap
            changed = [(i, k) for i, (b, c) in enumerate(zip(before, warm._cache))
                       for k in b if not torch.equal(b[k], c[k][pages])]
            if changed:
                raise AssertionError(f"{name}: donated pages changed under decode: {changed[:4]}")
            held = len({p for e in warm._prefix._entries for p in e.pages or ()})
            if end["pages_in_use"] != held:
                raise AssertionError(f"{name}: {end['pages_in_use']} pages in use, entries hold {held}")
        ties = sum(_tie_checked(warm, f"{name} mixed wave {label}", p, got, ref)
                   for label, p, got, ref in zip(("warm", "cold 1.5k", "300-id"), wave, wave_out,
                                                 wave_refs))
        if end["prefix_cache_hits"] - hits != 1:
            raise AssertionError(f"{name}: the mixed wave's warm row did not hit")
    finally:
        warm.shutdown()
        del warm
        gc.collect()
        torch.cuda.empty_cache()

    cold_ttft = [t for _, t, _ in cold_runs]
    warm_ttft = [t for _, t, _ in warm_runs[1:]]
    out.update({
        "ttft_cold_s": {"p50": statistics.median(cold_ttft), "max": max(cold_ttft)},
        "ttft_warm_s": {"p50": statistics.median(warm_ttft), "max": max(warm_ttft)},
        "ttft_first_warm_engine_s": warm_runs[0][1],
        "warm_over_cold_p50": statistics.median(warm_ttft) / statistics.median(cold_ttft),
        "chunks_cold": n_chunks, "chunks_warm": 1, "hits": hits, "misses": misses,
        "tokens_reused": st["prefix_cache_tokens_reused"],
        "copy_dispatches": st["prefix_copy_dispatches"], "pages_mapped": st["prefix_pages_mapped"],
        "cache_bytes": cache_bytes, "dispatch_syncs": dispatch_syncs,
        "mixed_wave_ties": ties, "launches": launched,
        "syncs_by_thread": dict(syncs.counts), "wall_s": time.time() - t0,
    })
    log(f"  {name}: {PREFIX_QUESTIONS} warm streams token-identical to the cold ones; prefill "
        f"chunks a request cold {n_chunks}, warm 1; hits {hits}, misses {misses}, tokens reused "
        f"{out['tokens_reused']}; store copies {out['copy_dispatches']}, pages mapped "
        f"{out['pages_mapped']}; dispatch-thread syncs {dispatch_syncs}"
        + ("; donated pages bitwise unchanged, pages in use = the entries' pages" if snap else ""))
    log(f"  {name}: TTFT cold p50 {out['ttft_cold_s']['p50']:.4f} s max {out['ttft_cold_s']['max']:.4f} s; "
        f"warm p50 {out['ttft_warm_s']['p50']:.4f} s max {out['ttft_warm_s']['max']:.4f} s "
        f"(warm / cold p50 {out['warm_over_cold_p50']:.3f}; the warm engine's first, a miss, "
        f"{out['ttft_first_warm_engine_s']:.4f} s); mixed wave: {3 - ties} of 3 rows equal to "
        f"their cold references, {ties} parted at a tie; launches {launched}; on {smi}")
    return out


def phase_prefix(dev, smi, seed=0) -> dict:
    """The prefix KV cache on recipes A and D (module docstring, phase 9)."""
    from generativeaiexamples_tpu_torch.models import llama

    t0 = time.time()
    out = {}
    cut = _cut_model(PREFIX_CUT_LAYERS)
    for name, quantization, kv_dtype, layout, expected in RECIPES:
        if name in PREFIX_RECIPES:
            model = cut if name in PREFIX_CUT_RECIPES else MODEL
            out[name] = prefix_recipe(dev, smi, name, quantization, kv_dtype, layout, expected,
                                      seed, model)
            out[name]["layers"] = llama.PRESETS[model].num_layers
    launches = collections.Counter()
    for r in out.values():
        launches.update(r["launches"])
    log(f"phase prefix: ok ({time.time() - t0:.1f} s)")
    return {"recipes": {n: {k: v for k, v in r.items() if k != "launches"} for n, r in out.items()},
            "launches": dict(launches)}


# --------------------------------------------------------------------- #
# Phase 10: the file chains (structured_data, multimodal)

# the public Azure predictive-maintenance errors table (PdM_errors.csv):
# 3,919 error events of 5 classes over 100 machines in 2015; two uploads
# split it, a third upload has PdM_machines.csv's columns
PDM_ERRORS_ROWS, PDM_MACHINES = 3919, 100
FILE_QUESTIONS = (
    "How many errors did machine 17 have?",
    "Which machine had the most errors?",
    "How many errors of type error3 are there in total?",
    "What is the most common errorID?",
)
# the stub VLM's fixed answers: a chart's table and a photo's caption
VLM_TABLE = "Month | Errors\nJan | 412\nFeb | 388\nMar | 405"
VLM_CAPTION = "A photograph of a pump on a factory floor."
VLM_KINDS = ("detect", "table", "caption", "transcribe")


class _StubVLM(BaseHTTPRequestHandler):
    """An OpenAI-compatible multimodal ``/v1/chat/completions`` that answers
    the graph flow's four prompts from what it knows of each image (by its
    bytes): detect says yes for a chart (``charts``), no otherwise; the
    table prompt gets ``VLM_TABLE``; the caption prompt ``VLM_CAPTION``;
    the transcribe prompt the page's planted text (``pages``). It counts
    its calls by kind."""

    charts: set = set()
    pages: dict = {}
    calls: collections.Counter = collections.Counter()
    lock = threading.Lock()

    def do_POST(self):  # noqa: N802 - http.server's name
        import base64

        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        prompt, image = body["messages"][0]["content"]
        data = base64.b64decode(image["image_url"]["url"].split(",", 1)[1])
        text = prompt["text"]
        if "yes or no" in text:
            kind, answer = "detect", "yes" if data in self.charts else "no"
        elif "data table" in text:
            kind, answer = "table", VLM_TABLE
        elif "Transcribe" in text:
            kind, answer = "transcribe", self.pages.get(data, "")
        else:
            kind, answer = "caption", VLM_CAPTION
        with self.lock:
            type(self).calls[kind] += 1
        out = json.dumps({"choices": [{"message": {"role": "assistant", "content": answer}}]})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out.encode())

    def log_message(self, *args):
        pass


class _Stopwatch:
    """Seconds by kind of work, summed over calls of patched functions
    (``patch``); ``record`` keeps the first argument of each call too (the
    chunks handed to ``index_chunks``). ``restore`` undoes every patch."""

    def __init__(self):
        self.seconds, self.recorded, self._undo = collections.Counter(), [], []

    def patch(self, owner, name, kind, record=False):
        real = getattr(owner, name)

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.seconds[kind] += time.perf_counter() - t
                if record:
                    self.recorded.append(list(args[0]))

        setattr(owner, name, timed)
        self._undo.append((owner, name, real))

    def restore(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self._undo.clear()


def _pdm_csvs(rng):
    """(name, bytes): the errors table in two parts and a machines table."""
    start = np.datetime64("2015-01-01T06:00:00")
    hours = np.sort(rng.randint(0, 24 * 365, PDM_ERRORS_ROWS))
    machines = rng.randint(1, PDM_MACHINES + 1, PDM_ERRORS_ROWS)
    errors = rng.randint(1, 6, PDM_ERRORS_ROWS)
    rows = [f"{str(start + np.timedelta64(int(h), 'h')).replace('T', ' ')},{m},error{e}\n"
            for h, m, e in zip(hours, machines, errors)]
    half = PDM_ERRORS_ROWS // 2
    head = "datetime,machineID,errorID\n"
    models = rng.randint(1, 5, PDM_MACHINES)
    ages = rng.randint(0, 21, PDM_MACHINES)
    machines_csv = "machineID,model,age\n" + "".join(
        f"{i + 1},model{m},{a}\n" for i, (m, a) in enumerate(zip(models, ages)))
    return [("PdM_errors_h1.csv", (head + "".join(rows[:half])).encode()),
            ("PdM_errors_h2.csv", (head + "".join(rows[half:])).encode()),
            ("PdM_machines.csv", machines_csv.encode())]


def _multimodal_files(rng):
    """The phase's three documents, their planted table and scan text, and
    the images the stub VLM must know: (files, table rows, scan lines,
    chart images)."""
    import io

    from PIL import Image, ImageDraw

    from generativeaiexamples_tpu_torch.chains.pptx_parser import write_pptx
    from generativeaiexamples_tpu_torch.retrieval import ocr
    from generativeaiexamples_tpu_torch.retrieval import pdf as pdf_mod

    letters = list("abcdefghijklmnopqrstuvwxyz")

    def words(n):
        return ["".join(rng.choice(letters, int(rng.randint(5, 10)))) for _ in range(n)]

    def encoded(arr, fmt):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        return buf.getvalue()

    prose = [" ".join(words(12)) + "." for _ in range(40)]
    table = [["machine", "component", "error", "month", "count"]] + [words(5) for _ in range(11)]
    chart = np.full((240, 320, 3), 255, np.uint8)
    chart[::24, :] = 40
    chart[:, ::32] = 40
    for k, h in enumerate(rng.randint(40, 200, 8)):
        chart[240 - h:, 36 + 34 * k:60 + 34 * k] = (200, 60, 40)
    y, x = np.mgrid[0:240, 0:320].astype(np.float32)
    photo = np.clip(np.stack([127 + 120 * np.sin(0.05 * x + 0.03 * y),
                              127 + 120 * np.cos(0.04 * x - 0.02 * y),
                              127 + 120 * np.sin(0.03 * (x + y))], -1)
                    + rng.normal(0, 4, (240, 320, 3)), 0, 255).astype(np.uint8)
    scan_lines = ["Maintenance report for the pump fleet", "Quarterly error count fell by 12."]
    page = Image.new("L", (1000, 40 + 60 * len(scan_lines)), 255)
    draw = ImageDraw.Draw(page)
    for i, line in enumerate(scan_lines):
        draw.text((20, 20 + 60 * i), line, fill=0, font=ocr._find_font(32))
    page = np.asarray(page)
    chart_jpeg, chart_png = encoded(chart, "JPEG"), encoded(chart[::2, ::2].copy(), "PNG")
    files = [
        ("report.pdf", pdf_mod.write_pdf([
            (pdf_mod.text_ops(prose), []),
            (pdf_mod.table_ops(table), []),
            (pdf_mod.text_ops(["Figure 1: errors by month."]), [("jpeg", chart_jpeg, 320, 240)]),
            (pdf_mod.text_ops(["Figure 2: the pump."]), [("jpeg", encoded(photo, "JPEG"), 320, 240)]),
        ])),
        ("scan.pdf", pdf_mod.write_pdf([(b"", [("raw", page.tobytes(), page.shape[1],
                                                page.shape[0], 1)])])),
        ("deck.pptx", write_pptx([["Pump fleet review", " ".join(words(8))],
                                  [" ".join(words(10)), " ".join(words(10))],
                                  ["Next steps", " ".join(words(6))]],
                                 media={"image1.png": chart_png})),
    ]
    return files, table, scan_lines, {chart_jpeg, chart_png}


def _chunk_key(chunk):
    """(type, text, source) of a chunk, a chart's engine-written
    explanation cut out: "[image i in f] <explanation>\\n<table>" and
    "[image i in f] <table>" read the same."""
    text = chunk.text
    if text.startswith("[image ") and text.endswith(VLM_TABLE):
        text = text[:text.index("] ") + 2] + VLM_TABLE
    return (chunk.metadata.get("type", "text"), text, chunk.source)


def phase_filechains(dev, smi, seed=0, dep=None, encoders=None, keep=False):
    """The file chains through the port's chain server on the card (module
    docstring, phase 10): ``dep`` is phase 7's deployment, still up, or
    None to build one (with phase 6's ``encoders`` when given). Returns the
    results and, when ``keep``, the deployment still up for phase 11."""
    import logging
    import os
    import tempfile

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import multimodal, pptx_parser, registry, runtime
    from generativeaiexamples_tpu_torch.chains import structured_data
    from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG, NO_DOCS_MSG
    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.retrieval import pdf as pdf_mod
    from generativeaiexamples_tpu_torch.server.api import make_server

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    if dep is None:
        dep = _rag_deploy(encoders)
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s) and {EMBED_MODEL}/"
             f"{RERANK_MODEL} {'from phase 6' if encoders is not None else 'by the factories'}")
    else:
        note("phase 7's engine A and encoders")
    # phase 8's remote leg leaves the LLM pointed at the engine server
    saved = {k: os.environ.get(k) for k in ("APP_MULTIMODAL_VLM_URL", "CSV_NAME", "EXAMPLE_NAME",
                                            "APP_RETRIEVER_NRPIPELINE", "APP_LLM_SERVERURL")}
    cwd = os.getcwd()
    servers, out = [], {}
    watch = _Stopwatch()
    records = []

    class _Records(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Records(logging.INFO)
    sd_logger = logging.getLogger(structured_data.__name__)
    sd_logger.addHandler(handler)
    sd_level = sd_logger.level
    sd_logger.setLevel(logging.INFO)

    def serve(example):
        server = make_server("127.0.0.1", 0, registry.resolve_example(example))
        thread = threading.Thread(target=server.serve_forever, name=f"smoke-{example}-server",
                                  daemon=True)
        thread.start()
        servers.append((server, thread))
        return f"http://127.0.0.1:{server.server_address[1]}"

    try:
        os.environ.update(RAG_ENV)
        os.environ.pop("APP_LLM_SERVERURL", None)
        config_mod.get_config.cache_clear()
        config, engine = config_mod.get_config(), dep["engine"]
        recorder = _RecordingEngine(engine, seed=CHAIN_SEED)
        llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
        llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(engine=recorder)
        vlm = ThreadingHTTPServer(("127.0.0.1", 0), _StubVLM)
        vlm_thread = threading.Thread(target=vlm.serve_forever, name="smoke-stub-vlm", daemon=True)
        vlm_thread.start()
        servers.append((vlm, vlm_thread))
        os.environ["APP_MULTIMODAL_VLM_URL"] = f"http://127.0.0.1:{vlm.server_address[1]}"
        work = tempfile.mkdtemp(prefix="filechains_", dir=dep["tmp"])
        os.chdir(work)  # ingested_csv_files.txt is relative to the working directory
        rng = np.random.RandomState(seed + 10)
        csvs = _pdm_csvs(rng)
        mm_files, table, scan_lines, charts = _multimodal_files(rng)
        src = os.path.join(work, "src")
        os.makedirs(src)
        for name, data in csvs + mm_files:
            with open(os.path.join(src, name), "wb") as fh:
                fh.write(data)
        _StubVLM.charts = charts
        scan_png = pdf_mod.extract_pdf_images(os.path.join(src, "scan.pdf"))
        _StubVLM.pages = {scan_png[0]: "\n".join(scan_lines)} if scan_png else {}
        ocr_reads = multimodal.ocr_image_local(scan_png[0]) if scan_png else ""
        branches = {}
        for mod in ("PIL", "cv2", "scipy", "matplotlib", "pytesseract"):
            try:
                __import__(mod)
                branches[mod] = True
            except ImportError:
                branches[mod] = False
        note(f"optional modules on this machine: {branches}; the template OCR reads the scan as "
             f"{ocr_reads!r} ({'OCR' if ocr_reads else 'the VLM transcribes it'})")
        if not branches["PIL"] or not scan_png:
            raise AssertionError("no PIL: the scan's FlateDecode page cannot be re-encoded")

        # the port's CPU path: each document's chunks, captured before any
        # embedding, with an empty explanation for charts
        expected, stub_expected = {}, {}
        real_index, real_get_llm = runtime.index_chunks, runtime.get_llm

        class _Silent:
            def stream_chat(self, messages, **kwargs):
                return iter(())

        try:
            for name, _ in mm_files:
                captured = []
                runtime.index_chunks = lambda chunks, coll, *a, **k: captured.extend(chunks)
                runtime.get_llm = lambda *a, **k: _Silent()
                before = collections.Counter(_StubVLM.calls)
                multimodal.MultimodalRAG().ingest_docs(os.path.join(src, name), name)
                expected[name] = sorted(map(_chunk_key, captured))
                stub_expected[name] = dict(_StubVLM.calls - before)
        finally:
            runtime.index_chunks, runtime.get_llm = real_index, real_get_llm
        _StubVLM.calls = collections.Counter()

        stats0 = engine.stats()
        t_phase = time.perf_counter()
        reset_counts()
        with SyncCounter() as syncs:
            # 1. structured_data: the errors table in two uploads, a third refused
            os.environ["EXAMPLE_NAME"] = "structured_data"
            os.environ["CSV_NAME"] = "PdM_errors"
            base = serve("structured_data")
            upload_dir = os.environ["DOC_UPLOAD_DIR"]
            for k, (name, data) in enumerate(csvs):
                raw, ctype = _multipart(name, data)
                status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
                want = ((200, {"message": "File uploaded successfully"}) if k < 2 else
                        (500, {"message": f"Columns of the file {upload_dir}/{name} do not match "
                                          f"the reference columns of {upload_dir}/{csvs[0][0]}\n"
                                          f" file."}))
                if (status, json.loads(text)) != want:
                    raise AssertionError(f"structured_data POST /documents {name}: {status} {text}")
            status, text = _http(base, "GET", "/documents")
            if json.loads(text)["documents"] != [csvs[0][0], csvs[1][0]]:
                raise AssertionError(f"structured_data GET /documents: {status} {text}")
            questions = []
            recorder.greedy = True
            for q in FILE_QUESTIONS:
                with recorder._lock:
                    recorder.prompts.clear()
                records.clear()
                s0 = engine.stats()
                frames, first, total = _generate_stream(base, q, True, max_tokens=64,
                                                        temperature=0.1)
                s1 = engine.stats()
                answer = _check_answer(f"structured_data {q!r}", frames, (NO_DOCS_MSG,))
                with recorder._lock:
                    texts = [engine.tokenizer.decode(p) for p in recorder.prompts]
                    ids = [len(p) for p in recorder.prompts]
                codegen = sum("You write small, correct pandas programs" in t for t in texts)
                spoken = sum("Formulate a natural-language reply" in t for t in texts)
                failed = sum(m.startswith("Generated code failed") for m in records)
                requests = s1["requests_prefilled"] - s0["requests_prefilled"]
                if answer.strip() == NO_CONTEXT_MSG:
                    path = "no_context"
                    ok = codegen == structured_data.MAX_CODE_RETRIES and spoken == 0 and any(
                        m.startswith("Retrieval failed") for m in records)
                else:
                    path = "answered"
                    ok = 1 <= codegen <= structured_data.MAX_CODE_RETRIES and spoken == 1
                if not ok or requests != codegen + spoken or len(texts) != requests:
                    raise AssertionError(
                        f"structured_data {q!r}: {path} after {codegen} code-generation and "
                        f"{spoken} answer prompts, {requests} engine requests, {failed} logged "
                        f"failures")
                questions.append({
                    "question": q, "path": path, "completions": codegen, "answer_streams": spoken,
                    "failures_logged": failed, "prompt_ids": ids, "ttft_s": first,
                    "seconds": total,
                    "chunked_prefills": s1["prefill_chunks"] - s0["prefill_chunks"]})
                note(f"structured_data {q!r}: {path}; {codegen} code-generation completions "
                     f"({failed} programs failed), {spoken} answer stream; prompts {ids} ids; "
                     f"{questions[-1]['chunked_prefills']} prefill chunks; {total:.3f} s on {smi}")
            recorder.greedy = False
            status, text = _http(base, "DELETE", f"/documents?filename={csvs[0][0]}")
            status2, text2 = _http(base, "GET", "/documents")
            if status != 200 or json.loads(text2)["documents"] != [csvs[1][0]]:
                raise AssertionError(f"structured_data DELETE: {status} {text}; {text2}")
            out["structured_data"] = {"questions": questions, "rows": PDM_ERRORS_ROWS}

            # 2. multimodal: three documents through the graph flow, then answers
            os.environ["EXAMPLE_NAME"] = "multimodal"
            # on random weights a reranker's order is noise, and multimodal's
            # /search passes score_threshold 0.0, so every chunk would reach
            # it: the fused dense + BM25 order (hybrid) is what can be checked
            os.environ["APP_RETRIEVER_NRPIPELINE"] = "hybrid"
            config_mod.get_config.cache_clear()
            base = serve("multimodal")
            for owner, name in ((pdf_mod, "iter_content_streams"), (pdf_mod, "extract_pdf_text"),
                                (pdf_mod, "extract_pdf_tables"), (pdf_mod, "extract_pdf_images"),
                                (pptx_parser, "extract_pptx_text"),
                                (pptx_parser, "extract_pptx_images")):
                watch.patch(owner, name, "parse")
            watch.patch(multimodal, "ocr_image_local", "ocr")
            watch.patch(multimodal.VLMCaptioner, "caption", "vlm")
            watch.patch(multimodal.GraphFlow, "_explain", "explain")
            watch.patch(runtime, "index_chunks", "embed", record=True)
            ingest = {}
            with recorder._lock:
                recorder.prompts.clear()
            for name, data in mm_files:
                watch.seconds.clear()
                watch.recorded.clear()
                before = collections.Counter(_StubVLM.calls)
                raw, ctype = _multipart(name, data)
                t = time.perf_counter()
                status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
                seconds = time.perf_counter() - t
                if status != 200:
                    raise AssertionError(f"multimodal POST /documents {name}: {status} {text}")
                got = sorted(_chunk_key(c) for chunks in watch.recorded for c in chunks)
                if got != expected[name]:
                    raise AssertionError(f"multimodal {name}: the served chunks {got} differ from "
                                         f"the CPU path's {expected[name]}")
                stub = dict(_StubVLM.calls - before)
                if stub != stub_expected[name]:
                    raise AssertionError(f"multimodal {name}: the stub VLM saw {stub}, the CPU "
                                         f"path {stub_expected[name]}")
                kinds = collections.Counter(k for k, _, _ in got)
                ingest[name] = {"seconds": seconds, **{k: watch.seconds.get(k, 0.0) for k in
                                                      ("parse", "ocr", "vlm", "explain", "embed")},
                                "chunks": dict(kinds), "vlm_calls": stub}
                note(f"multimodal {name}: {seconds:.3f} s (parse {ingest[name]['parse']:.3f}, OCR "
                     f"{ingest[name]['ocr']:.3f}, VLM {ingest[name]['vlm']:.3f}, explain "
                     f"{ingest[name]['explain']:.3f}, embed {ingest[name]['embed']:.3f}) on {smi}; "
                     f"chunks {dict(kinds)}, equal to the CPU path's; stub VLM calls {stub}")
            watch.restore()
            stub_total = {k: _StubVLM.calls.get(k, 0) for k in VLM_KINDS}
            want_stub = {"detect": 3, "table": 2, "caption": 1,
                         "transcribe": 0 if ocr_reads else 1}
            if stub_total != want_stub:
                raise AssertionError(f"stub VLM calls {stub_total}, expected {want_stub}")
            with recorder._lock:
                explains = [len(p) for p in recorder.prompts
                            if multimodal.GraphFlow.EXPLAIN_SYSTEM in engine.tokenizer.decode(p)]
            if len(explains) != want_stub["table"]:
                raise AssertionError(f"{len(explains)} _explain engine requests for "
                                     f"{want_stub['table']} charts")
            ocr_chunks = [t for k, t, s in expected["scan.pdf"] if k == "ocr"]
            if not ocr_chunks or (not ocr_reads and ocr_chunks != ["\n".join(scan_lines)]):
                raise AssertionError(f"scan.pdf's ocr chunks: {ocr_chunks}")
            planted = " ".join(table[4][:3])
            status, text = _http(base, "POST", "/search", {"query": planted, "top_k": 4})
            chunks = json.loads(text)["chunks"] if status == 200 else []
            if not any(c["content"].startswith("[table 0 in report.pdf]") for c in chunks):
                raise AssertionError(f"multimodal /search {planted!r}: {status} {text[:300]}")
            answers = {}
            # the scan's own OCR text (what the template OCR or the VLM read)
            for key, query in (("table", planted), ("scan", ocr_chunks[0])):
                with recorder._lock:
                    recorder.prompts.clear()
                frames, first, _ = _generate_stream(base, query, True)
                _check_answer(f"multimodal {key}", frames, (NO_CONTEXT_MSG, NO_DOCS_MSG))
                with recorder._lock:
                    ids = [len(p) for p in recorder.prompts]
                answers[key] = {"ttft_s": first, "prompt_ids": ids}
            status, text = _http(base, "DELETE", "/documents?filename=deck.pptx")
            status2, text2 = _http(base, "GET", "/documents")
            left = sorted(json.loads(text2)["documents"])
            if status != 200 or left != ["report.pdf", "scan.pdf"]:
                raise AssertionError(f"multimodal DELETE deck.pptx: {status} {text}; {text2}")
            note(f"multimodal: stub VLM calls {stub_total}; {len(explains)} _explain engine "
                 f"requests ({explains} ids); /search {planted!r} finds the table chunk; "
                 f"/generate TTFT " + ", ".join(f"{k} {v['ttft_s']:.3f} s ({v['prompt_ids']} ids)"
                                                for k, v in answers.items())
                 + f"; DELETE deck.pptx leaves {left} on {smi}")
        launched = counts()
        wall = time.perf_counter() - t_phase
        missing = [n for n in RAG_EXPECTED if launched[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched by the file chains: {missing}")
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while the file chains ran")
        stats1 = engine.stats()
        out["multimodal"] = {"ingest": ingest, "vlm_calls": stub_total,
                             "explain_prompt_ids": explains, "answers": answers,
                             "ocr_branch": "template_ocr" if ocr_reads else "vlm",
                             "modules": branches}
        out.update({"launches": launched, "dispatch_syncs": dispatch_syncs, "wall_s": wall,
                    "prefill_chunks": stats1["prefill_chunks"] - stats0["prefill_chunks"],
                    "engine_requests": stats1["requests_prefilled"] - stats0["requests_prefilled"],
                    "prefix_cache": _prefix_counts(stats0, stats1)})
        note(f"launches in the phase: " + ", ".join(f"{n} {launched[n]}" for n in RAG_EXPECTED)
             + f"; {out['engine_requests']} engine requests, {out['prefill_chunks']} prefill "
             f"chunks; LLM dispatch thread syncs {dispatch_syncs}; phase wall {wall:.1f} s on {smi}")
    finally:
        watch.restore()
        sd_logger.removeHandler(handler)
        sd_logger.setLevel(sd_level)
        os.chdir(cwd)
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(60)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        config_mod.get_config.cache_clear()
        if not keep or sys.exc_info()[0] is not None:
            _rag_teardown(dep)
    log(f"phase filechains: ok ({time.time() - t0:.1f} s)")
    return out, (dep if keep else None)


# --------------------------------------------------------------------- #
# Phase 21: the applications built on the stack (after phase 10, before 11)

APPS_TOKENS = 48  # every engine request of the phase decodes at most this many tokens
APPS_QUESTIONS = 8  # (a): one planted question for each of 8 of phase 7's documents
APPS_TRANSCRIPT_WORDS = 600  # (c): the replayed transcript
APPS_REPLAY_WORDS = 20  # (c): words a /storeStreamingText post
APPS_STREAM_QUESTIONS = 3  # (c): greedy /generate, then the first asked again
APPS_CHAT_TURNS = 2  # (d): /chat turns with the fact check
APPS_SIMILARITY_TOL = 1e-3  # (a): a row's cosine recomputed here against the harness's mean
APPS_BUDGET_S = 120.0
# the evaluation result's keys, as the JAX harness names them
APPS_RESULT_KEYS = {"faithfulness", "answer_relevancy", "context_relevancy", "context_precision",
                    "context_recall", "answer_similarity", "ragas_score", "llm_judge_mean",
                    "llm_judge_ratings"}


class _ThreadOutput:
    """``sys.stdout``/``sys.stderr`` while phase 21 runs: a thread inside
    ``captured()`` writes to its own buffers, every other thread to the
    stream this replaced (the legs run side by side, and only (b) keeps
    what it prints)."""

    def __init__(self, stream):
        self.stream, self.buffers = stream, {}

    def _target(self):
        return self.buffers.get(threading.get_ident(), self.stream)

    def write(self, text):
        return self._target().write(text)

    def flush(self):
        self._target().flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)

    @staticmethod
    @contextlib.contextmanager
    def captured():
        """(stdout, stderr) buffers of this thread's output meanwhile."""
        import io

        bufs, me = (io.StringIO(), io.StringIO()), threading.get_ident()
        for proxy, buf in zip((sys.stdout, sys.stderr), bufs):
            proxy.buffers[me] = buf
        try:
            yield bufs
        finally:
            for proxy in (sys.stdout, sys.stderr):
                proxy.buffers.pop(me, None)


class _AppsEngine(_RecordingEngine):
    """Engine A behind phase 21's apps: every request decodes at most
    APPS_TOKENS tokens (the apps ask for up to 1024); the prompts are
    recorded and (with ``seed``) the sampling seed pinned as phase 8's are."""

    def stream_text(self, prompt_ids, params=None, timeout=None):
        params = dataclasses.replace(params, max_tokens=min(params.max_tokens, APPS_TOKENS))
        return super().stream_text(prompt_ids, params, timeout)


def _sse_frames(base, path, body, timeout=600) -> tuple:
    """One streamed POST: (the frames, seconds to the first answer frame
    (a frame that is no ``*status*`` line; the end when there is none),
    seconds to the end). Every ``data:`` line must parse."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    frames, first = [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if not line:
                continue
            if not line.startswith("data: "):
                raise AssertionError(f"{path}: not an SSE data line: {line[:80]!r}")
            frames.append(json.loads(line[6:]))
            content = frames[-1]["choices"][0]["message"]["content"]
            if first is None and content and not content.startswith("*"):
                first = time.perf_counter() - t0
    total = time.perf_counter() - t0
    return frames, first if first is not None else total, total


def _apps_silent(engine, reqs, what) -> int:
    """How many of ``reqs`` (the engine requests behind empty answers)
    decoded no text: the random model's ids were all past the byte range
    or a stop (an empty answer is then the right one). Raises otherwise."""
    if not reqs:
        raise AssertionError(f"{what}: an empty answer with no engine request behind it")
    for req in reqs:
        text = engine.tokenizer.decode(req.emitted)
        if text.strip():
            raise AssertionError(f"{what}: an empty answer where the engine decoded {text[:80]!r}")
    return len(reqs)


def _apps_generate_data(dep, work, note) -> dict:
    """(a)'s ``generate-data`` on one of phase 7's documents (one chunk):
    the pairs the random model's reply parses to."""
    from generativeaiexamples_tpu_torch.tools.evaluation import main as evaluation

    _, files = dep["corpus"]
    out_path = os.path.join(work, "generated_qna.json")
    t = time.perf_counter()
    evaluation.main(["generate-data", "--docs", os.path.join(work, "docs", files[0][0]),
                     "--output", out_path, "--max-chunks", "1"])
    with open(out_path) as fh:
        out = {"pairs_parsed": len(json.load(fh)), "seconds": time.perf_counter() - t}
    note(f"apps (a) generate-data on {files[0][0]} (1 chunk): {out['pairs_parsed']} QnA pairs "
         f"parsed from the random model's reply ({out['seconds']:.2f} s)")
    return out


def _apps_evaluation(dep, work, rng, engine, snapshot, note) -> dict:
    """(a): the evaluation harness's ``generate-answers`` and ``evaluate``
    in process, against the port's chain server on the deployment (their
    printed lines go to this script's output)."""
    from generativeaiexamples_tpu_torch.chains import registry, runtime
    from generativeaiexamples_tpu_torch.server.api import make_server
    from generativeaiexamples_tpu_torch.tools.evaluation import evaluator
    from generativeaiexamples_tpu_torch.tools.evaluation import main as evaluation

    docs, files = dep["corpus"]
    present = set(runtime.get_vector_store("default").sources())
    picked = [k for k in range(RAG_DOCS) if files[k][0] in present][:APPS_QUESTIONS]
    if len(picked) < APPS_QUESTIONS:
        raise AssertionError(f"apps (a): {len(picked)} of phase 7's documents left in 'default'")
    qna = []
    for k in picked:
        sentence = docs[k][1 + int(rng.randint(0, len(docs[k]) - 1))]
        words = sentence.rstrip(".").split()
        qna.append({"question": f"What does the document say about {' '.join(words[:4])}?",
                    "ground_truth_answer": sentence,
                    "ground_truth_context": " ".join(docs[k][:3]), "document": files[k][0]})
    paths = {name: os.path.join(work, name) for name in ("qna.json", "eval.json", "results.json")}
    with open(paths["qna.json"], "w") as fh:
        json.dump(qna, fh)
    out = {}
    server = make_server("127.0.0.1", 0, registry.resolve_example("developer_rag"))
    thread = threading.Thread(target=server.serve_forever, name="smoke-apps-chain-server",
                              daemon=True)
    thread.start()
    try:
        t = time.perf_counter()
        evaluation.main(["generate-answers", "--qna", paths["qna.json"], "--server",
                         f"http://127.0.0.1:{server.server_address[1]}",
                         "--output", paths["eval.json"]])
        answers_s = time.perf_counter() - t
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
    with open(paths["eval.json"]) as fh:
        rows = json.load(fh)
    if len(rows) != APPS_QUESTIONS:
        raise AssertionError(f"apps (a) generate-answers wrote {len(rows)} rows")
    silent = 0
    for row in rows:
        if not row["contexts"]:
            raise AssertionError(f"apps (a) generate-answers: no context for {row['question']!r}")
        if not row["answer"].strip():
            silent += _apps_silent(engine, [
                r for r in snapshot() if row["question"] in engine.tokenizer.decode(r.prompt_ids)],
                f"apps (a) generate-answers {row['question']!r}")
    with open(paths["eval.json"] + ".timing.json") as fh:
        timing = json.load(fh)
    out["generate_answers"] = {"rows": len(rows), "silent_answers": silent,
                               "seconds": answers_s, **timing}
    note(f"apps (a) generate-answers over HTTP: {len(rows)} rows ({silent} answers empty: the "
         f"random model decoded no text there), each with "
         f"{min(len(r['contexts']) for r in rows)}-{max(len(r['contexts']) for r in rows)} "
         f"contexts; p50 latency {timing['p50_latency_s']:.3f} s, p50 TTFT "
         f"{timing['p50_ttft_s']:.3f} s ({answers_s:.1f} s)")

    # the judge's replies (this thread's: the other legs share the
    # backend), parsed here as the harness parses them
    backend = runtime.get_llm()
    replies, me = [], threading.get_ident()
    real_complete = backend.complete

    def complete(messages, **kwargs):
        text = real_complete(messages, **kwargs)
        if threading.get_ident() == me:
            replies.append((kwargs.get("max_tokens"), text))
        return text

    backend.complete = complete
    t = time.perf_counter()
    try:
        evaluation.main(["evaluate", "--eval", paths["eval.json"], "--output",
                         paths["results.json"]])
    finally:
        del backend.complete
    evaluate_s = time.perf_counter() - t
    with open(paths["results.json"]) as fh:
        results = json.load(fh)
    ragas = [evaluator.parse_score(text) for n, text in replies if n == 16]
    likert = [evaluator.parse_score(text, 1.0, 5.0) for n, text in replies if n == 8]
    if len(ragas) != 5 * len(rows) or len(likert) != len(rows):
        raise AssertionError(f"apps (a) evaluate: {len(ragas)} RAGAS and {len(likert)} Likert "
                             f"judge calls for {len(rows)} rows")
    if not set(results) <= APPS_RESULT_KEYS:
        raise AssertionError(f"apps (a) evaluate: keys {sorted(results)} are not JAX's")
    for key, value in results.items():
        low, high = (1.0, 5.0) if key.startswith("llm_judge") else (0.0, 1.0)
        values = value if isinstance(value, list) else [value]
        if not all(isinstance(v, float) and low <= v <= high for v in values):
            raise AssertionError(f"apps (a) evaluate: {key} = {value!r} outside [{low}, {high}]")
    # answer similarity, row by row (the harness scores the rows with an
    # answer whose embedding is not zero)
    emb = runtime.get_embedder()
    cosines = []
    for row in rows:
        if not row["answer"]:
            continue
        a, b = (np.asarray(v, np.float64) for v in emb.embed_documents(
            [row["answer"], row["ground_truth_answer"]]))
        denom = float(np.linalg.norm(a) * np.linalg.norm(b))
        if denom > 0:
            cosines.append(max(0.0, float(a @ b) / denom))
    if not all(np.isfinite(cosines)) or ("answer_similarity" in results) != bool(cosines) or \
            (cosines and abs(results["answer_similarity"] - float(np.mean(cosines)))
             > APPS_SIMILARITY_TOL):
        raise AssertionError(f"apps (a) evaluate: answer_similarity "
                             f"{results.get('answer_similarity')} against the rows' cosines "
                             f"{cosines}")
    out["evaluate"] = {"results": results, "judge_calls": len(replies),
                       "ragas_parsed": sum(s is not None for s in ragas), "ragas_calls": len(ragas),
                       "likert_parsed": sum(s is not None for s in likert),
                       "likert_calls": len(likert), "answer_similarity_rows": cosines,
                       "seconds": evaluate_s}
    note(f"apps (a) evaluate: {len(replies)} judge calls on engine A, "
         f"{out['evaluate']['ragas_parsed']}/{len(ragas)} RAGAS and "
         f"{out['evaluate']['likert_parsed']}/{len(likert)} Likert replies parsed; keys "
         f"{sorted(results)}; answer_similarity {results.get('answer_similarity')} over "
         f"{len(cosines)} rows ({evaluate_s:.1f} s)")
    return out


def _apps_five_min(work, engine, snapshot, note) -> dict:
    """(b): the five-minute RAG's ``main`` in process over phase 7's files."""
    from generativeaiexamples_tpu_torch.examples import five_min_rag

    question = "What do the documents say about the first topic?"
    t = time.perf_counter()
    with _ThreadOutput.captured() as (stdout, stderr):
        five_min_rag.main(["--docs", os.path.join(work, "docs"), "-q", question])
    seconds = time.perf_counter() - t
    err, answer = stderr.getvalue(), stdout.getvalue()
    chunks = sum(int(n) for n in re.findall(r"^  ingested .+: (\d+) chunks$", err, re.M))
    ready = re.search(r"Knowledge base ready: (\d+) files, (\d+) chunks\.", err)
    if not ready or int(ready.group(2)) != chunks or not chunks:
        raise AssertionError(f"apps (b) five_min_rag: the store holds "
                             f"{ready.group(2) if ready else '?'} chunks, {chunks} printed")
    if not answer.strip():  # or the random model decoded no text
        _apps_silent(engine, [r for r in snapshot()
                              if question in engine.tokenizer.decode(r.prompt_ids)],
                     "apps (b) five_min_rag")
    note(f"apps (b) five_min_rag --docs ({ready.group(1)} files): {chunks} chunks in the faiss "
         f"store, as printed; a {len(answer.strip())}-character answer ({seconds:.1f} s)")
    return {"files": int(ready.group(1)), "chunks": chunks, "answer_chars": len(answer.strip()),
            "seconds": seconds}


def _apps_streaming(dep, work, note) -> dict:
    """(c): the streaming-transcript RAG server fed through the replay
    client, then greedy questions over /generate, the first asked again."""
    from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import replay
    from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.server import (
        create_streaming_app,
    )

    docs, _ = dep["corpus"]
    words = " ".join(s for d in docs for s in d).split()[:APPS_TRANSCRIPT_WORDS]
    path = os.path.join(work, "transcript.txt")
    with open(path, "w") as fh:
        fh.write(" ".join(words))
    server = create_streaming_app()
    thread = threading.Thread(target=server.serve_forever, name="smoke-apps-streaming",
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = {"questions": []}
    try:
        t = time.perf_counter()
        sent = replay.replay(path, base, "fm", APPS_REPLAY_WORDS, 0.0)
        out.update(words=len(words), posts=sent, replay_s=time.perf_counter() - t)
        if sent != -(-len(words) // APPS_REPLAY_WORDS):
            raise AssertionError(f"apps (c) replay sent {sent} posts for {len(words)} words")
        questions = [f"What was said about {' '.join(w.strip('.') for w in words[i:i + 3])}?"
                     for i in (40, 260, 480)][:APPS_STREAM_QUESTIONS]
        texts = []
        for q in questions + questions[:1]:
            frames, first, total = _sse_frames(base, "/generate", {
                "question": q, "temperature": 0, "max_tokens": APPS_TOKENS})
            if not frames or frames[-1]["choices"][0]["finish_reason"] != "[DONE]":
                raise AssertionError(f"apps (c) {q!r}: the stream does not end in [DONE]")
            content = "".join(f["choices"][0]["message"]["content"] for f in frames)
            if not content.strip() or "*error:" in content:
                raise AssertionError(f"apps (c) {q!r}: answered {content[:200]!r}")
            texts.append(content)
            out["questions"].append({"question": q, "ttft_s": first, "wall_s": total,
                                     "frames": len(frames)})
            note(f"apps (c) /generate {q!r}: {len(frames)} frames ending in [DONE], TTFT "
                 f"{first:.3f} s, wall {total:.3f} s")
        out["repeat"] = (questions[0], texts[0], texts[-1])
        note(f"apps (c) replay of {len(words)} words in {sent} posts ({out['replay_s']:.2f} s)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
    return out


def _apps_repeat(engine, requests, repeat) -> dict:
    """(c)'s repeated question: its two answer requests (the RAG prompt
    holding the question) got the same prompt, and the second's greedy ids
    equal the first's or part at a tie (``_tie_checked``; the legs ran side
    by side, so the two prefills may have shared their waves with others)."""
    question, first, second = repeat
    found = [r for r in requests if f"User: '{question}'" in engine.tokenizer.decode(r.prompt_ids)]
    if len(found) != 2 or found[0].prompt_ids != found[1].prompt_ids:
        raise AssertionError(f"apps (c): {len(found)} answer requests for the repeated question, "
                             f"or two prompts")
    tie = _tie_checked(engine, "apps (c) the repeated question", list(found[0].prompt_ids),
                       list(found[1].emitted), list(found[0].emitted))
    if not tie and first != second:
        raise AssertionError(f"apps (c): the same greedy ids, other text: {first!r} / {second!r}")
    return {"equal": first == second, "tie": tie}


def _apps_oran(work, mm_files, note) -> dict:
    """(d): the O-RAN chatbot: an upload, chat turns with the fact check,
    feedback."""
    from generativeaiexamples_tpu_torch.experimental.oran_chatbot.app import create_oran_app

    server = create_oran_app(feedback_path=os.path.join(work, "feedback.jsonl"))
    thread = threading.Thread(target=server.serve_forever, name="smoke-apps-oran", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = {"chats": []}
    try:
        name, data = mm_files[0]
        raw, ctype = _multipart(name, data)
        status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
        if status != 200 or not json.loads(text).get("chunks"):
            raise AssertionError(f"apps (d) POST /documents {name}: {status} {text[:200]}")
        out["upload"] = {"file": name, "chunks": json.loads(text)["chunks"]}
        for i in range(APPS_CHAT_TURNS):
            t = time.perf_counter()
            status, text = _http(base, "POST", "/chat", {
                "question": f"What does the report say about the pump fleet? ({i + 1})",
                "fact_check": True})
            body = json.loads(text) if status == 200 else {}
            if status != 200 or set(body) != {"answer", "sources", "fact_check"} or \
                    body["sources"] != [name]:
                raise AssertionError(f"apps (d) /chat {i}: {status} {text[:300]}")
            out["chats"].append({"seconds": time.perf_counter() - t,
                                 "fact_check_passed": body["fact_check"]["passed"],
                                 "answer_chars": len(body["answer"])})
        status, text = _http(base, "GET", "/feedback/summary")
        before = json.loads(text)
        status, text = _http(base, "POST", "/feedback", {
            "question": "pump fleet", "answer": body["answer"], "rating": 1, "sources": [name]})
        if status != 200 or not json.loads(text).get("recorded"):
            raise AssertionError(f"apps (d) /feedback: {status} {text}")
        status, text = _http(base, "GET", "/feedback/summary")
        after = json.loads(text)
        if after != {"total": before["total"] + 1, "up": before["up"] + 1, "down": before["down"]}:
            raise AssertionError(f"apps (d) /feedback/summary {before} -> {after}")
        out["feedback_summary"] = after
        note(f"apps (d) O-RAN chatbot: {name} in {out['upload']['chunks']} chunks; "
             f"{APPS_CHAT_TURNS} /chat turns with the fact check "
             + ", ".join(f"{c['seconds']:.2f} s (verdict {c['fact_check_passed']})"
                         for c in out["chats"]) + f"; feedback summary {after}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
    return out


def _apps_multimodal(work, mm_files, table, note) -> dict:
    """(e): the multimodal assistant over phase 10's files, asked about
    the report's planted table row and the pump fleet (the words BM25
    finds: the dense hits are held under RAG_ENV's threshold)."""
    from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG, NO_DOCS_MSG
    from generativeaiexamples_tpu_torch.experimental.multimodal_assistant import (
        MultimodalAssistant,
    )

    folder = os.path.join(work, "multimodal")
    os.makedirs(folder)
    for name, data in mm_files:
        with open(os.path.join(folder, name), "wb") as fh:
            fh.write(data)
    assistant = MultimodalAssistant()
    t = time.perf_counter()
    ingested = assistant.ingest_directory(folder)
    ingest_s = time.perf_counter() - t
    if sorted(ingested) != sorted(n for n, _ in mm_files) or \
            not set(ingested) <= set(assistant.documents()):
        raise AssertionError(f"apps (e) ingested {ingested}, listed {assistant.documents()}")
    answers = []
    for q in (f"What does the table say about {' '.join(table[4][:3])}?",
              "What does the pump fleet review say?"):
        t = time.perf_counter()
        tokens = list(assistant.ask(q))
        text = "".join(str(x) for x in tokens)
        if any(not isinstance(x, str) for x in tokens) or text.strip() in (NO_CONTEXT_MSG,
                                                                            NO_DOCS_MSG):
            raise AssertionError(f"apps (e) {q!r}: answered {text[:200]!r}")
        answers.append({"question": q, "seconds": time.perf_counter() - t,
                        "answer_chars": len(text)})
    note(f"apps (e) multimodal assistant: {sorted(ingested)} ingested in {ingest_s:.1f} s; "
         + ", ".join(f"{a['seconds']:.2f} s" for a in answers) + " a question")
    return {"ingested": sorted(ingested), "ingest_s": ingest_s, "answers": answers}


def phase_apps(dev, smi, seed=0, dep=None, encoders=None, keep=False):
    """The applications built on the stack, on phase 7's deployment (module
    docstring, phase 21): ``dep`` is that deployment, still up, or None to
    build one and ingest phase 7's corpus. Returns the results and, when
    ``keep``, the deployment still up for phase 11."""
    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.engine import llm_backend

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    if dep is None:
        dep = _rag_deploy_ingested(seed, encoders)
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s) and phase 7's documents")
    else:
        note("phase 7's engine A, encoders and 'default' collection")
    config, engine = config_mod.get_config(), dep["engine"]
    llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
    saved_backend = llm_backend._LLM_CACHE.get(llm_key)
    llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(
        engine=_AppsEngine(engine, seed=CHAIN_SEED))
    requests, lock = [], threading.Lock()
    real_submit = engine.submit

    def submit(*args, **kwargs):  # every request of the phase, for its prompt and emitted ids
        req = real_submit(*args, **kwargs)
        with lock:
            requests.append(req)
        return req

    def snapshot():
        with lock:
            return list(requests)

    engine.submit = submit
    work = tempfile.mkdtemp(prefix="apps_", dir=dep["tmp"])
    rng = np.random.RandomState(seed + 21)
    out, walls = {}, {}

    def timed(leg, fn):
        t = time.perf_counter()
        out[leg] = fn()
        walls[leg] = time.perf_counter() - t

    def in_turn(*legs):
        def run():
            for leg, fn in legs:
                timed(leg, fn)
        return run

    try:
        _, files = dep["corpus"]
        os.makedirs(os.path.join(work, "docs"))
        for name, data in files:
            with open(os.path.join(work, "docs", name), "wb") as fh:
                fh.write(data)
        mm_rng = np.random.RandomState(seed + 10)  # phase 10's draws, in its order
        _pdm_csvs(mm_rng)
        mm_files, mm_table = _multimodal_files(mm_rng)[:2]
        stats0 = engine.stats()
        t_phase = time.perf_counter()
        reset_counts()
        # the apps side by side in three threads, as one deployment serves
        # several: (a)'s answers and their evaluation (the longest), (a)'s
        # generate-data, (b) and (d), and (c) and (e)
        sys.stdout, sys.stderr = _ThreadOutput(sys.stdout), _ThreadOutput(sys.stderr)
        try:
            _concurrently({
                "evaluation": in_turn(("evaluation", lambda: _apps_evaluation(
                    dep, work, rng, engine, snapshot, note))),
                "data_five_min_oran": in_turn(
                    ("generate_data", lambda: _apps_generate_data(dep, work, note)),
                    ("five_min_rag", lambda: _apps_five_min(work, engine, snapshot, note)),
                    ("oran", lambda: _apps_oran(work, mm_files, note))),
                "streaming_multimodal": in_turn(
                    ("streaming", lambda: _apps_streaming(dep, work, note)),
                    ("multimodal", lambda: _apps_multimodal(work, mm_files, mm_table, note)))})
        finally:
            sys.stdout, sys.stderr = sys.stdout.stream, sys.stderr.stream
        launched = counts()
        wall = time.perf_counter() - t_phase
        done = snapshot()
        out["streaming"]["repeat"] = _apps_repeat(engine, done, out["streaming"]["repeat"])
        missing = [n for n in ("int8_matmul", "paged_attention[bfloat16]") if launched[n] == 0]
        if missing:
            raise AssertionError(f"apps: kernels never launched by the applications: {missing}")
        long = [len(r.emitted) for r in done if len(r.emitted) > APPS_TOKENS]
        if long:
            raise AssertionError(f"apps: requests decoded {long} tokens, over {APPS_TOKENS}")
        stats1 = engine.stats()
        out.update({"launches": launched, "wall_s": wall, "walls_s": walls,
                    "engine_requests": stats1["requests_prefilled"] - stats0["requests_prefilled"],
                    "tokens": sum(len(r.emitted) for r in done),
                    "prefix_cache": _prefix_counts(stats0, stats1)})
        same = out["streaming"]["repeat"]["equal"]
        note(f"apps (c) the repeated question's answer "
             f"{'equals' if same else 'parts at a tie from'} the first")
        note(f"launches in the phase: " + ", ".join(f"{n} {launched[n]}" for n in RAG_EXPECTED)
             + f"; {out['engine_requests']} engine requests, {out['tokens']} tokens; walls "
             + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
             + f"; phase wall {wall:.1f} s on {smi}")
        if wall > APPS_BUDGET_S:
            log(f"  apps: the phase took {wall:.1f} s, over its {APPS_BUDGET_S:.0f} s budget")
    finally:
        del engine.submit
        if saved_backend is None:
            llm_backend._LLM_CACHE.pop(llm_key, None)
        else:
            llm_backend._LLM_CACHE[llm_key] = saved_backend
        shutil.rmtree(work, ignore_errors=True)
        if not keep or sys.exc_info()[0] is not None:
            _rag_teardown(dep)
    log(f"phase apps: ok ({time.time() - t0:.1f} s)")
    return out, (dep if keep else None)


# --------------------------------------------------------------------- #
# Phase 22: agents: streaming ingest, CVE triage, the Triton-protocol client

AGENTS_KINDS = ("txt", "md", "txt", "html", "txt", "md")  # (a): the files' kinds, in turn
AGENTS_FILES = 96  # (a): 48 .txt, 32 .md, 16 .html of 8-16 KB
AGENTS_RSS, AGENTS_ATOM, AGENTS_KAFKA = 128, 64, 128  # (a): feed entries, Kafka messages
# (a): each file opens with a planted sentence of this many words, > 512
# bytes: the encoder reads a chunk's first 512 byte ids, so a random
# encoder gives the planted query and the file's first chunk the same input
AGENTS_PLANTED_WORDS = 100
AGENTS_SAMPLED = 64  # (a): stored vectors held against a direct embed_documents
AGENTS_COSINE = 0.999  # (a): a row alone and in a batch part by up to 1.7e-3 on the card
AGENTS_CVES = 4  # (b): CVEs through the CLI, 4 at once
AGENTS_SBOM = 200  # (b): packages in the SBOM
AGENTS_SCORE_TOL = 1e-4  # (b): the tool's top 4 against the host's, f32 dot products
AGENTS_BUDGET_S = 60.0
# (b): the identifiers the 12 code files call, one each
AGENTS_IDENTIFIERS = ("etree.iterwalk", "etree.canonicalize", "yaml.load", "pickle.loads",
                      "subprocess.Popen", "tarfile.extractall", "xml.sax.parseString",
                      "jinja2.Template", "zipfile.ZipFile", "marshal.loads", "shelve.open",
                      "ssl.wrap_socket")
AGENTS_CVE_TEXTS = (
    "CVE-2022-2309: lxml through 4.9.1 has a NULL pointer dereference in etree.iterwalk when "
    "the iterator is used on a tree whose root was modified.",
    "CVE-2020-1747: PyYAML before 5.3.1 runs arbitrary code through yaml.load with the "
    "FullLoader on untrusted YAML.",
    "CVE-2007-4559: tarfile.extractall in CPython up to 3.11.3 follows member names with '..' "
    "and writes outside the target directory.",
    "CVE-2019-20477: pickle.loads and marshal.loads of untrusted input in services built on "
    "cloudpickle up to 1.3.0 execute attacker code.",
)
# (c): the CVE the Triton-protocol client drives through the pipeline
AGENTS_TRITON_CVE = ("CVE-2023-27043: email.utils.parseaddr in CPython up to 3.11.4 accepts "
                     "addresses with special characters and misreads their domain.")
# (c): the KServe-v2 input tensors of JAX's client, by name and datatype
AGENTS_TRITON_INPUTS = (("text_input", "BYTES"), ("max_tokens", "INT32"), ("temperature", "FP32"),
                        ("runtime_top_k", "INT32"), ("runtime_top_p", "FP32"),
                        ("beam_width", "INT32"), ("repetition_penalty", "FP32"),
                        ("len_penalty", "FP32"))
AGENTS_VERDICT_KEYS = {"cve_info", "checklist", "findings", "exploitable", "summary"}


def _agents_words(rng, n, vocab):
    return " ".join(rng.choice(vocab, n))


def _agents_corpus(rng, work) -> dict:
    """(a) and (b)'s inputs under ``work``, drawn from ``rng``: the 96
    files (each opening with its planted sentence), the RSS 2.0 and Atom
    feeds, the Kafka messages, the 12 code files, the CVEs and the SBOM."""
    from xml.sax.saxutils import escape

    letters = list("abcdefghijklmnopqrstuvwxyz")
    vocab = np.array(sorted({"".join(rng.choice(letters, int(rng.randint(4, 10))))
                             for _ in range(6000)}))
    out = {"files": [], "rss": [], "atom": [], "kafka": [], "code": []}
    os.makedirs(os.path.join(work, "files"))
    for i in range(AGENTS_FILES):
        kind = AGENTS_KINDS[i % len(AGENTS_KINDS)]
        planted = _agents_words(rng, AGENTS_PLANTED_WORDS, vocab) + "."
        target, sentences = int(rng.randint(8192, 16385)), []
        size = len(planted)
        while size < target:
            sentences.append(_agents_words(rng, int(rng.randint(8, 15)), vocab) + ".")
            size += len(sentences[-1]) + 1
        paras = [" ".join(sentences[k:k + 6]) for k in range(0, len(sentences), 6)]
        if kind == "md":
            body = planted + "\n\n" + "".join(f"## Part {k}\n\n{p}\n\n" for k, p in enumerate(paras))
        elif kind == "html":
            body = ("<html><head><style>p {margin: 0}</style></head><body>"
                    f"<p>{planted}</p>" + "".join(f"<p>{p}</p>" for p in paras) + "</body></html>")
        else:
            body = planted + "\n" + "\n".join(paras)
        path = os.path.join(work, "files", f"doc{i:03d}.{kind}")
        with open(path, "w") as fh:
            fh.write(body)
        out["files"].append((path, planted))
    items = []
    for i in range(AGENTS_RSS):
        entry = (f"Bulletin {i} {_agents_words(rng, 3, vocab)}", f"https://feeds.example/rss/{i}",
                 _agents_words(rng, int(rng.randint(40, 400)), vocab))
        out["rss"].append(entry)
        items.append(f"<item><title>{escape(entry[0])}</title><link>{entry[1]}</link>"
                     f"<description>{escape(entry[2])}</description></item>")
    out["rss_path"] = os.path.join(work, "news.rss.xml")
    with open(out["rss_path"], "w") as fh:
        fh.write('<?xml version="1.0"?>\n<rss version="2.0"><channel><title>news</title>'
                 + "".join(items) + "</channel></rss>")
    entries = []
    for i in range(AGENTS_ATOM):
        entry = (f"Advisory {i} {_agents_words(rng, 3, vocab)}", f"urn:agents:atom:{i}",
                 _agents_words(rng, int(rng.randint(40, 400)), vocab))
        out["atom"].append(entry)
        entries.append(f"<entry><title>{escape(entry[0])}</title><id>{entry[1]}</id>"
                       f'<link href="https://feeds.example/atom/{i}"/>'
                       f"<summary>{escape(entry[2])}</summary></entry>")
    out["atom_path"] = os.path.join(work, "advisories.atom.xml")
    with open(out["atom_path"], "w") as fh:
        fh.write('<?xml version="1.0" encoding="utf-8"?>\n'
                 '<feed xmlns="http://www.w3.org/2005/Atom"><title>advisories</title>'
                 + "".join(entries) + "</feed>")
    for i in range(AGENTS_KAFKA):
        out["kafka"].append((f"kafka-{i}", _agents_words(rng, int(rng.randint(30, 700)), vocab)))
    os.makedirs(os.path.join(work, "code"))
    for k, ident in enumerate(AGENTS_IDENTIFIERS):
        module = ident.split(".")[0]
        filler = "\n".join(f"    # {_agents_words(rng, 8, vocab)}" for _ in range(4))
        text = (f'"""Handlers of service {k}."""\nimport {module}\n\n\n'
                f"def handle_{k}(payload, options=None):\n{filler}\n"
                f"    result = {ident}(payload)\n    return result\n")
        path = os.path.join(work, "code", f"service_{k:02d}.py")
        with open(path, "w") as fh:
            fh.write(text)
        out["code"].append((path, ident, text))
    out["cves_path"] = os.path.join(work, "cves.jsonl")
    with open(out["cves_path"], "w") as fh:
        for text in AGENTS_CVE_TEXTS:
            fh.write(json.dumps({"cve_info": text}) + "\n")
    named = [("lxml", "4.8.0"), ("pyyaml", "5.3"), ("cpython", "3.11.2"), ("cloudpickle", "1.2.2")]
    out["sbom_path"] = os.path.join(work, "sbom.csv")
    with open(out["sbom_path"], "w") as fh:
        fh.write("name,version\n")
        for name, version in named + [
                (f"pkg-{vocab[j]}", f"{rng.randint(0, 9)}.{rng.randint(0, 30)}.{rng.randint(0, 99)}")
                for j in rng.choice(len(vocab), AGENTS_SBOM - len(named), replace=False)]:
            fh.write(f"{name},{version}\n")
    return out


def _agents_expected(corpus) -> tuple:
    """What (a)'s two runs must store, computed here on the host: the
    (source, text) chunks the port's loader and splitter make of each
    file, feed entry and message (the JAX defaults: 512 words, overlap 64;
    an Atom link is an href with no text, so an entry's id is its title, as
    JAX's parser reads it), and the files the loader cannot read."""
    from generativeaiexamples_tpu_torch.retrieval.loaders import load_document
    from generativeaiexamples_tpu_torch.retrieval.splitter import get_text_splitter

    split = get_text_splitter(512, 64).split_text
    ingest, skipped = [], []
    for path, _ in corpus["files"]:
        try:
            text = load_document(path)
        except Exception as exc:  # noqa: BLE001 - the pipeline skips such a file too
            skipped.append((os.path.basename(path), f"{type(exc).__name__}: {exc}"))
            continue
        ingest += [(path, c) for c in split(text)]
    for title, link, body in corpus["rss"]:
        ingest += [(link, c) for c in split(f"{title}\n{body}")]
    for title, _, body in corpus["atom"]:
        ingest += [(title, c) for c in split(f"{title}\n{body}")]
    code = [(key, c) for key, value in corpus["kafka"] for c in split(value)]
    code += [(path, c) for path, _, text in corpus["code"] for c in split(load_document(path))]
    return sorted(ingest), sorted(code), skipped


def _agents_rows(store) -> tuple:
    """A port store's (chunks, host matrix) as they stand."""
    with store._lock:
        return list(store._chunks), store._matrix.copy()


def _agents_ingest_checks(emb, store, want, docs_want, stats, planted, what, note) -> dict:
    """(a)'s checks on one collection: ``docs_in``, ``chunks_out`` and the
    store's count, the (source, text) multiset, AGENTS_SAMPLED stored
    vectors against a direct ``embed_documents`` of their texts, and (with
    ``planted``: (file, sentence) pairs) each planted sentence's file at
    top 1."""
    chunks, matrix = _agents_rows(store)
    got = sorted((c.source, c.text) for c in chunks)
    if stats["docs_in"] != docs_want or stats["chunks_out"] != len(want) or \
            store.count() != len(want):
        raise AssertionError(f"agents (a) {what}: docs_in {stats['docs_in']} (want {docs_want}), "
                             f"chunks_out {stats['chunks_out']}, stored {store.count()} "
                             f"(want {len(want)})")
    if got != want:
        missing = len(set(want) - set(got))
        raise AssertionError(f"agents (a) {what}: the stored chunks differ from the splitter's "
                             f"({missing} missing, {len(set(got) - set(want))} extra)")
    rng = np.random.RandomState(len(want))
    rows = rng.choice(len(chunks), min(AGENTS_SAMPLED, len(chunks)), replace=False)
    direct = np.asarray(emb.embed_documents([chunks[r].text for r in rows]), np.float64)
    direct /= np.linalg.norm(direct, axis=1, keepdims=True)
    cos = np.sum(direct * matrix[rows].astype(np.float64), axis=1)
    if not cos.min() >= AGENTS_COSINE:
        raise AssertionError(f"agents (a) {what}: a stored vector against embed_documents of its "
                             f"text: cosine {cos.min():.6f} < {AGENTS_COSINE}")
    out = {"docs_in": stats["docs_in"], "chunks": len(want), "cosine_min": float(cos.min()),
           "cosine_mean": float(cos.mean())}
    if planted:
        # the query embedded as the chunks are (embed_query prepends the
        # arctic query prefix, which changes the encoder's leading input)
        vecs = emb.embed_documents([s for _, s in planted])
        misses = [os.path.basename(p) for (p, _), v in zip(planted, vecs)
                  if store.search(v, 1)[0].chunk.source != p]
        if misses:
            raise AssertionError(f"agents (a) {what}: planted sentences whose file is not the top "
                                 f"hit: {misses}")
        out["planted_top1"] = len(planted)
    note(f"agents (a) {what}: docs_in {stats['docs_in']}, {len(want)} chunks stored as the "
         f"splitter makes them; {len(rows)} stored vectors against embed_documents: cosine "
         f"{cos.min():.6f}-{cos.max():.6f}"
         + (f"; {len(planted)} planted sentences, each its file's top hit" if planted else ""))
    return out


def _triton_stub(engine):
    """A Triton-protocol server on ``http.server`` over ``engine``:
    ``GET /v2/health/ready`` and ``POST /v2/models/ensemble/infer``, which
    decodes ``text_input`` greedily at the request's ``max_tokens`` capped
    to APPS_TOKENS and records each body, its headers and its reply."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    records, lock = [], threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, status, body=b""):
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._reply(200 if self.path == "/v2/health/ready" else 404)

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            if self.path != "/v2/models/ensemble/infer":
                self._reply(404)
                return
            inputs = {t["name"]: t["data"][0] for t in body["inputs"]}
            params = SamplingParams(temperature=0.0,
                                    max_tokens=min(int(inputs["max_tokens"]), APPS_TOKENS))
            text = "".join(engine.stream_text(engine.tokenizer.encode(inputs["text_input"]),
                                              params))
            with lock:
                records.append({"body": body, "authorization": self.headers.get("Authorization"),
                                "text_output": text})
            self._reply(200, json.dumps({"model_name": "ensemble", "outputs": [
                {"name": "text_output", "shape": [1, 1], "datatype": "BYTES",
                 "data": [text]}]}).encode())

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, name="smoke-agents-triton",
                              daemon=True)
    thread.start()
    return server, thread, records


def _implied_calls(verdict) -> int:
    """The LLM calls one verdict's dict implies: its checklist and its
    verdict, and for each item one call a tool step plus the call that gave
    the finding (none after the step limit of 4)."""
    return 2 + sum(len(f["steps"]) + (len(f["steps"]) < 4) for f in verdict["findings"])


def _agents_ingest(corpus, want, skipped, note) -> dict:
    """(a)'s second run: ``streaming_ingest.run.main`` over the files and
    feeds into ``agents_ingest``, its printed stats captured."""
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.experimental.streaming_ingest import run as ingest_run

    files = os.path.join(os.path.dirname(corpus["files"][0][0]), "*")
    t = time.perf_counter()
    with _ThreadOutput.captured() as (stdout, _):
        ingest_run.main(["--files", files, "--rss", corpus["rss_path"], corpus["atom_path"],
                         "--collection", "agents_ingest"])
    seconds = time.perf_counter() - t
    stats = json.loads(stdout.getvalue().strip().splitlines()[-1])
    readable = len(corpus["files"]) - len(skipped)
    planted = [(p, s) for p, s in corpus["files"]
               if os.path.basename(p) not in {name for name, _ in skipped}]
    out = _agents_ingest_checks(runtime.get_embedder(), runtime.get_vector_store("agents_ingest"),
                                want, readable + AGENTS_RSS + AGENTS_ATOM, stats, planted,
                                "run.main --files --rss", note)
    out.update(seconds=seconds, printed=stats, skipped=[name for name, _ in skipped],
               chunks_per_s=len(want) / seconds)
    note(f"agents (a) run.main: {len(want)} chunks of {stats['docs_in']} documents in "
         f"{stats['batches_embedded']} batches, {seconds:.2f} s ({out['chunks_per_s']:.1f} "
         f"chunks/s); {len(skipped)} files skipped"
         + (f" ({skipped[0][1]})" if skipped else ""))
    return out


def _agents_cve(engine, corpus, work, snapshot, note) -> dict:
    """(b): the CVE CLI in process on the deployment's LLM, then the code
    search of each planted identifier held against the host's top 4."""
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.experimental.cve_analysis import pipeline as cve_pipeline
    from generativeaiexamples_tpu_torch.experimental.cve_analysis.tools import CodeSearchTool

    out_path = os.path.join(work, "verdicts.jsonl")
    t = time.perf_counter()
    cve_pipeline.main(["--cves", corpus["cves_path"], "--sbom", corpus["sbom_path"],
                       "--code-collection", "cve_code", "--concurrency", str(AGENTS_CVES),
                       "--out", out_path])
    seconds = time.perf_counter() - t
    with open(out_path) as fh:
        rows = [json.loads(line) for line in fh]
    if [r.get("cve_info") for r in rows] != list(AGENTS_CVE_TEXTS) or \
            any(set(r) != AGENTS_VERDICT_KEYS for r in rows):
        raise AssertionError(f"agents (b): {len(rows)} verdict lines, keys "
                             f"{[sorted(r) for r in rows]}")
    reqs = [r for r in snapshot()
            if any(c in engine.tokenizer.decode(r.prompt_ids) for c in AGENTS_CVE_TEXTS)]
    implied = sum(_implied_calls(r) for r in rows)
    if len(reqs) != implied:
        raise AssertionError(f"agents (b): {len(reqs)} engine requests for the CVEs, the verdicts "
                             f"imply {implied}")
    tool = CodeSearchTool(runtime.get_embedder(), runtime.get_vector_store("cve_code"))
    chunks, matrix = _agents_rows(tool.store)
    found = []
    for ident in AGENTS_IDENTIFIERS:
        got = tool.search(ident).split("\n---\n")
        q = tool.embedder.embed_query(ident)  # the tool's query vector (the query cache's)
        scores = matrix @ (q / np.linalg.norm(q))
        best = {}
        for c, s in zip(chunks, scores):
            best[c.text[:400]] = max(best.get(c.text[:400], -2.0), float(s))
        want = np.sort(scores)[::-1][:tool.top_k]
        got_scores = np.array([best.get(g, np.nan) for g in got])
        if len(got) != len(want) or not np.all(np.abs(got_scores - want) <= AGENTS_SCORE_TOL):
            raise AssertionError(f"agents (b) code_search({ident!r}): scores {got_scores} against "
                                 f"the host's top {tool.top_k} {want}")
        found.append(any(f"{ident}(" in g for g in got))
    steps = sum(len(f["steps"]) for r in rows for f in r["findings"])
    out = {"seconds": seconds, "verdicts": len(rows), "llm_calls": implied,
           "checklist_items": [len(r["checklist"]) for r in rows], "tool_steps": steps,
           "exploitable": [r["exploitable"] for r in rows],
           "code_search_found": int(sum(found))}
    note(f"agents (b) CVE CLI: {len(rows)} verdicts with JAX's keys, checklists of "
         f"{out['checklist_items']} items, {steps} tool steps, {implied} LLM calls as the verdicts "
         f"imply ({seconds:.1f} s); code_search of {len(AGENTS_IDENTIFIERS)} identifiers equals the "
         f"host's top {tool.top_k}, the planted call in the result for {out['code_search_found']} "
         f"(random encoder weights)")
    return out


def _agents_triton(engine, note) -> dict:
    """(c): one CVE through ``CVEPipeline`` on ``TritonLLMBackend`` against
    the stub server on the deployment's engine."""
    from generativeaiexamples_tpu_torch.experimental.azureml import TritonLLMBackend
    from generativeaiexamples_tpu_torch.experimental.cve_analysis import CVEPipeline

    server, thread, records = _triton_stub(engine)
    try:
        backend = TritonLLMBackend(f"http://127.0.0.1:{server.server_address[1]}",
                                   api_key="smoke-token")
        if not backend.client.server_ready():
            raise AssertionError("agents (c): server_ready() is false")
        replies, real_infer = [], backend.client.infer

        def infer(*args, **kwargs):
            replies.append(real_infer(*args, **kwargs))
            return replies[-1]

        backend.client.infer = infer
        t = time.perf_counter()
        verdict = CVEPipeline(backend).run_sync([AGENTS_TRITON_CVE])[0].as_dict()
        seconds = time.perf_counter() - t
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)
    for rec in records:
        inputs = rec["body"]["inputs"]
        if [(i["name"], i["datatype"], i["shape"]) for i in inputs] != \
                [(n, d, [1, 1]) for n, d in AGENTS_TRITON_INPUTS] or \
                rec["authorization"] != "Bearer smoke-token":
            raise AssertionError(f"agents (c): a request body {inputs} "
                                 f"(authorization {rec['authorization']!r})")
    if replies != [r["text_output"] for r in records]:
        raise AssertionError("agents (c): the client's replies differ from the server's text_output")
    if len(records) != _implied_calls(verdict):
        raise AssertionError(f"agents (c): {len(records)} infer requests, the verdict implies "
                             f"{_implied_calls(verdict)}")
    note(f"agents (c) Triton protocol: server_ready, {len(records)} infer requests with JAX's eight "
         f"tensors and the bearer token, each reply the server's text_output, as many as the "
         f"verdict implies ({seconds:.1f} s)")
    return {"seconds": seconds, "infer_requests": len(records),
            "checklist_items": len(verdict["checklist"])}


def phase_agents(dev, smi, seed=0, dep=None, encoders=None, keep=False):
    """The rest of the JAX repository's experimental/ on phase 7's
    deployment (module docstring, phase 22): ``dep`` is that deployment,
    still up, or None to build one and ingest phase 7's corpus. Returns the
    results and, when ``keep``, the deployment still up for phase 11."""
    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.experimental.streaming_ingest import (
        IngestPipeline,
        PipelineConfig,
    )
    from generativeaiexamples_tpu_torch.experimental.streaming_ingest.sources import (
        FilesystemSource,
        KafkaSource,
    )

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    if dep is None:
        dep = _rag_deploy_ingested(seed, encoders)
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s) and phase 7's documents")
    else:
        note("phase 7's engine A, encoders and 'default' collection")
    config, engine = config_mod.get_config(), dep["engine"]
    llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
    saved_backend = llm_backend._LLM_CACHE.get(llm_key)
    llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(
        engine=_AppsEngine(engine, seed=CHAIN_SEED))
    requests, lock = [], threading.Lock()
    real_submit = engine.submit

    def submit(*args, **kwargs):  # every request of the phase, for its prompt and emitted ids
        req = real_submit(*args, **kwargs)
        with lock:
            requests.append(req)
        return req

    def snapshot():
        with lock:
            return list(requests)

    engine.submit = submit
    work = tempfile.mkdtemp(prefix="agents_", dir=dep["tmp"])
    out, walls = {}, {}
    try:
        t = time.perf_counter()
        corpus = _agents_corpus(np.random.RandomState(seed + 22), work)
        ingest_want, code_want, skipped = _agents_expected(corpus)
        note(f"agents inputs: {AGENTS_FILES} files, {AGENTS_RSS} RSS items, {AGENTS_ATOM} Atom "
             f"entries, {AGENTS_KAFKA} Kafka messages, {len(AGENTS_IDENTIFIERS)} code files; "
             f"expected {len(ingest_want)} + {len(code_want)} chunks "
             f"({time.perf_counter() - t:.1f} s)")
        emb = runtime.get_embedder()
        counters0 = dict(getattr(getattr(emb, "_batcher", None), "counters", {}) or {})
        stats0 = engine.stats()
        t_phase = time.perf_counter()
        reset_counts()
        # (a) first into cve_code (the pipeline driven directly: the Kafka
        # source and the code files), then (a)'s CLI beside (b) and (c)
        t = time.perf_counter()
        messages = list(corpus["kafka"])
        code_store = runtime.get_vector_store("cve_code")
        code_stats = IngestPipeline(
            PipelineConfig(collection="cve_code"), emb, code_store,
            sources=[KafkaSource(poll=lambda: messages.pop(0) if messages else None,
                                 idle_limit=2, poll_interval=0.01),
                     FilesystemSource([p for p, _, _ in corpus["code"]], name="code")]).run_sync()
        walls["ingest_code"] = time.perf_counter() - t
        out["ingest_code"] = _agents_ingest_checks(
            emb, code_store, code_want, AGENTS_KAFKA + len(AGENTS_IDENTIFIERS),
            code_stats.as_dict(), [], "IngestPipeline kafka+code", note)
        out["ingest_code"].update(seconds=walls["ingest_code"],
                                  chunks_per_s=len(code_want) / walls["ingest_code"])

        def timed(leg, fn):
            def run():
                t = time.perf_counter()
                out[leg] = fn()
                walls[leg] = time.perf_counter() - t
            return run

        sys.stdout, sys.stderr = _ThreadOutput(sys.stdout), _ThreadOutput(sys.stderr)
        try:
            _concurrently({
                "ingest": timed("ingest", lambda: _agents_ingest(corpus, ingest_want, skipped,
                                                                 note)),
                "cve": timed("cve", lambda: _agents_cve(engine, corpus, work, snapshot, note)),
                "triton": timed("triton", lambda: _agents_triton(engine, note))})
        finally:
            sys.stdout, sys.stderr = sys.stdout.stream, sys.stderr.stream
        launched = counts()
        wall = time.perf_counter() - t_phase
        done = snapshot()
        missing = [n for n in ("int8_matmul", "paged_attention[bfloat16]") if launched[n] == 0]
        if missing:
            raise AssertionError(f"agents: kernels never launched by the phase: {missing}")
        long = [len(r.emitted) for r in done if len(r.emitted) > APPS_TOKENS]
        if long:
            raise AssertionError(f"agents: requests decoded {long} tokens, over {APPS_TOKENS}")
        if len(done) != out["cve"]["llm_calls"] + out["triton"]["infer_requests"]:
            raise AssertionError(f"agents: {len(done)} engine requests, (b) and (c) account for "
                                 f"{out['cve']['llm_calls'] + out['triton']['infer_requests']}")
        stats1 = engine.stats()
        counters1 = dict(getattr(getattr(emb, "_batcher", None), "counters", {}) or {})
        gate = {k: counters1.get(k, 0) - counters0.get(k, 0)
                for k in ("ingest_gated_batches", "ingest_gate_wait_s")}
        chunks = len(ingest_want) + len(code_want)
        out.update({"launches": launched, "wall_s": wall, "walls_s": walls,
                    "engine_requests": len(done), "tokens": sum(len(r.emitted) for r in done),
                    "prompt_ids": [len(r.prompt_ids) for r in done],
                    "chunks_per_s": chunks / (walls["ingest_code"] + walls["ingest"]),
                    "ingest_gate": gate, "prefix_cache": _prefix_counts(stats0, stats1)})
        note(f"launches in the phase: " + ", ".join(f"{n} {launched[n]}" for n in RAG_EXPECTED)
             + f"; {len(done)} engine requests of {min(out['prompt_ids'], default=0)}-"
             f"{max(out['prompt_ids'], default=0)} prompt ids, {out['tokens']} tokens; "
             f"{chunks} chunks at {out['chunks_per_s']:.1f} chunks/s over (a)'s two runs "
             f"(the ingest gate held {gate['ingest_gated_batches']} batches "
             f"{gate['ingest_gate_wait_s']:.2f} s); walls "
             + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
             + f"; phase wall {wall:.1f} s on {smi}")
        if wall > AGENTS_BUDGET_S:
            log(f"  agents: the phase took {wall:.1f} s, over its {AGENTS_BUDGET_S:.0f} s budget")
        for name in ("agents_ingest", "cve_code"):  # the deployment goes on as it was
            store = runtime.get_vector_store(name)
            store.delete_sources(store.sources())
    finally:
        del engine.submit
        if saved_backend is None:
            llm_backend._LLM_CACHE.pop(llm_key, None)
        else:
            llm_backend._LLM_CACHE[llm_key] = saved_backend
        shutil.rmtree(work, ignore_errors=True)
        if not keep or sys.exc_info()[0] is not None:
            _rag_teardown(dep)
    log(f"phase agents: ok ({time.time() - t0:.1f} s)")
    return out, (dep if keep else None)


# --------------------------------------------------------------------- #
# Phase 11: drain and restore, the disagg scheduler, faults, the retrieval tier

# the bf16 paged pool over HTTP; the int4 pool, whose payload carries
# scales, is drained in phase 18 at TP=2 (for the script's time)
DRAIN_RECIPES = "A"
DRAIN_REQUESTS, DRAIN_TOKENS, DRAIN_IDS = 8, 64, (101, 157)
DRAIN_FAULT = "engine.dispatch:delay=0.05@1x0"
DRAIN_SLOTS_B = 12  # part (b): the 8 requests and the 4 long prompts decode together
DRAIN_LONG, DRAIN_LONG_IDS, DRAIN_LONG_TOKENS = 4, (1536, 2048), 16


def _drain_bodies(tokenizer, rng, redraw=(), bodies=None) -> list:
    """The 8 chat bodies of part (a): rendered prompts of 101-157 ids, 4
    greedy and 4 seeded at temperature 0.7, top_p 0.9, 64 tokens each.
    With ``bodies``, only the indices in ``redraw`` get new contents."""
    base = len(tokenizer.render_chat([("user", "")]))
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    lengths = np.linspace(DRAIN_IDS[0], DRAIN_IDS[1], DRAIN_REQUESTS).astype(int)
    if bodies is not None:
        bodies = list(bodies)
        for i in redraw:
            bodies[i] = dict(bodies[i], messages=[{"role": "user", "content": "".join(
                rng.choice(letters, int(lengths[i]) - base))}])
        return bodies
    bodies = []
    for i, n in enumerate(lengths):
        content = "".join(rng.choice(letters, int(n) - base))
        if len(tokenizer.render_chat([("user", content)])) != n:
            raise AssertionError("the byte tokenizer renders another prompt length")
        body = {"messages": [{"role": "user", "content": content}], "stream": True,
                "max_tokens": DRAIN_TOKENS, "temperature": 0.0}
        if i % 2:
            body.update(temperature=0.7, top_p=0.9, seed=1000 + i)
        bodies.append(body)
    return bodies


def _chat_sse(base, body, out, key) -> None:
    """One streamed chat completion into ``out[key]``: its data frames
    (JSON) and whether ``[DONE]`` ended it."""
    req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    frames, done = [], False
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                break
            frames.append(json.loads(line[6:]))
    out[key] = (frames, done)


def _serve_engine(engine):
    from generativeaiexamples_tpu_torch.engine.server import make_server

    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="smoke-drain-http", daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _recorded_submits(engine) -> list:
    """Record every request handle ``engine.submit`` returns."""
    handles, orig = [], engine.submit

    def submit(prompt_ids, params=None):
        req = orig(prompt_ids, params)
        handles.append(req)
        return req

    engine.submit = submit
    return handles


def _fire_wave(engine, base, bodies) -> tuple:
    """The bodies' streams started together and held until all wait in the
    admission queue, so they prefill as one wave (the same wave on every
    run). Returns (threads, results by index)."""
    out, threads = {}, []
    with engine.hold_admissions():
        for i, body in enumerate(bodies):
            t = threading.Thread(target=_chat_sse, args=(base, body, out, i),
                                 name=f"smoke-drain-stream-{i}", daemon=True)
            t.start()
            threads.append(t)
        deadline = time.time() + 120
        while engine.queue_depth() < len(bodies):
            if time.time() > deadline:
                raise AssertionError("the drain phase's wave never queued")
            time.sleep(0.005)
    return threads, out


def _join(threads, what) -> None:
    for t in threads:
        t.join(600)
        if t.is_alive():
            raise AssertionError(f"{what}: a stream did not end")


def drain_recipe(dev, smi, name, kv_dtype, spool, seed) -> tuple:
    """Part (a) on one recipe: undisturbed streams, then the same streams
    drained mid-decode and restored on a second engine of the same config
    (its own weights from the same seed) that shares only the spool."""
    import statistics as stats_mod

    from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.utils import faults

    t0 = time.time()
    cfg = EngineConfig(model_config_name=MODEL, quantization="int8", kv_cache_dtype=kv_dtype,
                       kv_layout="paged", snapshot_spool_dir=spool, tensor_parallelism=1)
    e1 = LLMEngine(cfg, device=dev)
    e2 = s1 = s2 = None
    out = {}
    try:
        build_s = time.time() - t0
        rng = np.random.RandomState(seed + ord(name))
        bodies = _drain_bodies(e1.tokenizer, rng)
        s1 = _serve_engine(e1)
        handles = _recorded_submits(e1)
        redrawn = 0
        for _ in range(6):
            handles.clear()
            threads, first = _fire_wave(e1, s1[2], bodies)
            _join(threads, f"{name} undisturbed")
            ref = {tuple(r.prompt_ids): list(r.emitted) for r in handles}
            if any(not first[i][1] for i in range(len(bodies))) or any(
                    len(v) != DRAIN_TOKENS and v[-1] not in e1._stop_ids for v in ref.values()):
                raise AssertionError(f"{name}: an undisturbed stream did not run to its end")
            # a stream that samples a stop id early (random weights) ends
            # before any drain: its prompt is drawn again
            short = [i for i, body in enumerate(bodies) if len(ref[tuple(
                e1.tokenizer.render_chat([("user", body["messages"][0]["content"])]))])
                < DRAIN_TOKENS]
            if not short:
                break
            redrawn += len(short)
            bodies = _drain_bodies(e1.tokenizer, rng, short, bodies)
        else:
            raise AssertionError(f"{name}: streams still stop early after 5 redraws")

        # the same wave, throttled by the fault, drained once each has a token
        handles.clear()
        faults.install(DRAIN_FAULT)
        try:
            threads, second = _fire_wave(e1, s1[2], bodies)
            deadline = time.time() + 120
            while len(handles) < len(bodies) or not all(r.generated >= 1 for r in handles):
                if time.time() > deadline:
                    raise AssertionError(f"{name}: the throttled wave produced no tokens")
                time.sleep(0.002)
            at_drain = [r.generated for r in handles]
            t1 = time.perf_counter()
            status, text = _post(s1[2], "/internal/drain", {})
            drain_s = time.perf_counter() - t1
        finally:
            faults.reset()
        _join(threads, f"{name} drained")
        summary = json.loads(text)
        if status != 200 or not summary["parked"] or summary["spooled"] != len(bodies):
            raise AssertionError(f"{name}: drain answered {status} {text[:300]}")
        gen = [len(r.emitted) for r in handles]
        if not all(1 <= g < DRAIN_TOKENS for g in gen):
            raise AssertionError(f"{name}: streams at the drain {gen} not within 1-63 tokens")
        sids = []
        for i in range(len(bodies)):
            frames, done = second[i]
            last = frames[-1] if frames else {}
            sid = (last.get("warnings") or [""])[0].removeprefix("preempted snapshot_id=")
            if not done or last["choices"][0]["finish_reason"] != "PREEMPTED" or not sid:
                raise AssertionError(f"{name}: stream {i} did not end PREEMPTED with a snapshot "
                                     f"id: {last}")
            sids.append(sid)
        status, text = _http(s1[2], "GET", "/internal/snapshots")
        listed = {d["snapshot_id"]: d for d in json.loads(text)["snapshots"]}
        if set(listed) != set(sids) or not all(d["restorable"] for d in listed.values()):
            raise AssertionError(f"{name}: /internal/snapshots lists {sorted(listed)}, "
                                 f"the streams named {sorted(sids)}")
        doc_bytes = [listed[s]["bytes"] for s in sids]

        # engine 2: same config, own weights, the shared spool; every document
        # relayed from engine 1's server into engine 2's
        t2 = time.time()
        e2 = LLMEngine(cfg, device=dev)
        build2_s = time.time() - t2
        s2 = _serve_engine(e2)
        restored, placed = [], {}
        orig_restore, orig_apply = e2.restore_snapshot, e2._apply_restore

        def restore(snap):
            result = orig_restore(snap)
            restored.append((snap, result))
            return result

        def apply(snap, payload, req):
            mode = orig_apply(snap, payload, req)
            if mode == "restore":
                n = int(snap.geometry["pages"])
                placed[req.rid] = list(e2._slot_pages[req.slot][:n])
            return mode

        e2.restore_snapshot, e2._apply_restore = restore, apply
        latencies0 = len(rs.restore_latencies)
        docs = {sid: _http(s1[2], "GET", f"/internal/snapshots/{sid}")[1] for sid in sids}
        relay = {}

        def relay_one(sid):
            req = urllib.request.Request(s2[2] + "/internal/restore", data=docs[sid].encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                header = resp.headers.get("X-GenAI-Restore")
                frames = [line.decode().strip() for line in resp if line.startswith(b"data: ")]
            relay[sid] = (header, frames)

        reset_counts()
        with SyncCounter() as syncs:
            rthreads = [threading.Thread(target=relay_one, args=(sid,), daemon=True,
                                         name=f"smoke-relay-{k}") for k, sid in enumerate(sids)]
            for t in rthreads:
                t.start()
            _join(rthreads, f"{name} restore relay")
            _settle(e2)
        launched = counts()
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        modes = [relay[sid][0] for sid in sids]
        if modes != [f"{sid}; mode=restore" for sid in sids]:
            raise AssertionError(f"{name}: restore modes {modes}")
        if not all(json.loads(relay[sid][1][-1][6:])["choices"][0]["finish_reason"] == "[DONE]"
                   for sid in sids):
            raise AssertionError(f"{name}: a restore stream did not end with [DONE]")
        # the restored pages hold the payload's rows bitwise
        diffs = []
        for snap, (req, _, _, _) in restored:
            payload = rs.decode_kv_payload(snap.kv)
            rows = snap.position
            for li, (got, want) in enumerate(zip(rs.read_pages(e2, placed[req.rid]), payload)):
                for key in want:
                    a = got[key].flatten(0, 1)[:rows].contiguous().view(torch.uint8)
                    b = want[key].flatten(0, 1)[:rows].contiguous().view(torch.uint8)
                    if not torch.equal(a, b):
                        diffs.append((snap.snapshot_id, li, key))
        if diffs:
            raise AssertionError(f"{name}: restored pages differ from the payload: {diffs[:4]}")
        wrong = [i for i, (snap, (req, _, _, _)) in enumerate(restored)
                 if list(req.emitted) != ref[tuple(snap.prompt_ids)]]
        if wrong:
            raise AssertionError(f"{name}: restored streams {wrong} differ from the undisturbed "
                                 f"ones (the restored pages equal the payload)")
        if dispatch_syncs:
            raise AssertionError(f"{name}: the dispatch thread waited for the card "
                                 f"{dispatch_syncs} times while it restored")
        pa_key = f"paged_attention[{kv_dtype}]"
        if launched[pa_key] == 0 or launched["int8_matmul"] == 0:
            raise AssertionError(f"{name}: the continuation launched {launched}")
        lat = list(rs.restore_latencies)[latencies0:]
        out = {
            "build_s": build_s, "build2_s": build2_s, "drain_s": drain_s,
            "tokens_at_drain": at_drain, "tokens_spooled": gen, "prompts_redrawn": redrawn,
            "snapshot_doc_bytes": statistics.mean(doc_bytes),
            "restore_latency_s": {"p50": stats_mod.median(lat), "max": max(lat), "n": len(lat)},
            "launches": launched, "dispatch_syncs": dispatch_syncs,
            "wall_s": time.time() - t0,
        }
        log(f"  {name} ({kv_dtype} pool): {len(bodies)} streams drained after "
            f"{min(gen)}-{max(gen)} tokens, all PREEMPTED with a snapshot id and listed; "
            f"restored on engine 2 (built in {build2_s:.1f} s), all mode=restore, the "
            f"restored pages bitwise the payload's, spooled + continued tokens equal to the "
            f"undisturbed streams for {len(bodies)}/{len(bodies)}; on {smi}")
        log(f"  {name}: drain {drain_s:.4f} s; snapshot document {out['snapshot_doc_bytes']:.0f} "
            f"bytes a request; restore latency p50 {out['restore_latency_s']['p50']:.4f} s, max "
            f"{out['restore_latency_s']['max']:.4f} s; the continuation launched {pa_key} "
            f"{launched[pa_key]} and int8_matmul {launched['int8_matmul']} times; dispatch-thread "
            f"syncs {dispatch_syncs}; on {smi}")
        params = e1.params
    finally:
        for srv in (s1, s2):
            if srv is not None:
                srv[0].shutdown()
                srv[0].server_close()
                srv[1].join(30)
        for eng in (e1, e2):
            if eng is not None:
                eng.shutdown()
                _free_engine(eng)
        del e1, e2
        gc.collect()
        torch.cuda.empty_cache()
    return out, params


def _free_engine(engine) -> None:
    """Drop a shut-down engine's device tensors (weights, pool, slot
    state), so the card's memory comes back even while something still
    holds the engine object (a request's error traceback does)."""
    for name in ("params", "_cache", "_prefix_store", "_tables", "_tokens_dev",
                 "_positions_dev", "_temps_dev", "_topps_dev", "_seeds_dev", "_live_dev"):
        setattr(engine, name, None)



def _policy_runs(dev, params, policy, short, long) -> dict:
    """Part (b) on one policy: the 8 requests alone, then again with the 4
    long prompts submitted once each of the 8 has 8 tokens. Streams,
    the decode wall step of each run, the handoff counters and the pages
    funded, and each thread's synchronizing calls."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.engine.scheduler import handoff

    cfg = EngineConfig(model_config_name=MODEL, quantization="int8", kv_cache_dtype="bfloat16",
                       kv_layout="paged", max_batch_size=DRAIN_SLOTS_B, scheduler_policy=policy,
                       tensor_parallelism=1)
    engine = LLMEngine(cfg, device=dev, params=params)
    funded, orig_fund = [], engine._fund

    def fund(claimed):
        got = orig_fund(claimed)
        funded.extend(len(engine._slot_pages[r.slot]) for r in got)
        return got

    engine._fund = fund
    out = {"runs": {}}
    try:
        for run in ("alone", "with_long"):
            funded.clear()
            h0, st0 = handoff.metrics_snapshot(), engine.stats()
            with SyncCounter() as syncs:
                with engine.hold_admissions():
                    reqs = [engine.submit(p, sp) for p, sp in short]
                if run == "with_long":
                    deadline = time.time() + 120
                    # (a stream that samples a stop id ends sooner)
                    while not all(r.generated >= 8 or r.finished for r in reqs):
                        if time.time() > deadline:
                            raise AssertionError(f"{policy}: the 8 requests stalled")
                        time.sleep(0.001)
                    with engine.hold_admissions():
                        reqs += [engine.submit(p, sp) for p, sp in long]
                for r in reqs:
                    _drain_ids(r.out_queue)
                _settle(engine)
            h1, st1 = handoff.metrics_snapshot(), engine.stats()
            steps = st1["decode_steps"] - st0["decode_steps"]
            out["runs"][run] = {
                "streams": [list(r.emitted) for r in reqs],
                "decode_step_ms": 1e3 * (st1["decode_time_s"] - st0["decode_time_s"]) / steps,
                "handoffs": h1["handoffs"] - h0["handoffs"],
                "handoff_pages": h1["handoff_pages"] - h0["handoff_pages"],
                "handoff_recompute": h1["handoff_recompute"] - h0["handoff_recompute"],
                "handoff_stall_s": h1["handoff_stall_seconds"] - h0["handoff_stall_seconds"],
                "handoff_wait_s": h1["handoff_wait_seconds"] - h0["handoff_wait_seconds"],
                "funded_pages": sum(funded),
                "syncs": {k: syncs.counts[k] for k in ("torch-llm-engine",
                                                       "torch-llm-prefill-tier")},
            }
    finally:
        engine.shutdown()
        _free_engine(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def drain_policies(dev, smi, params, seed) -> dict:
    """Part (b): ``disagg`` against ``unified`` on recipe A's weights."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    rng = np.random.RandomState(seed + 11)
    lengths = np.linspace(DRAIN_IDS[0], DRAIN_IDS[1], DRAIN_REQUESTS).astype(int)
    short = [([256] + [int(x) for x in rng.randint(1, 256, n - 1)],
              SamplingParams(temperature=0.0, max_tokens=DRAIN_TOKENS) if i % 2 == 0 else
              SamplingParams(temperature=0.7, top_p=0.9, max_tokens=DRAIN_TOKENS, seed=1000 + i))
             for i, n in enumerate(lengths)]
    long = [([256] + [int(x) for x in rng.randint(1, 256, int(n) - 1)],
             SamplingParams(temperature=0.0, max_tokens=DRAIN_LONG_TOKENS))
            for n in np.linspace(*DRAIN_LONG_IDS, DRAIN_LONG).astype(int)]
    t0 = time.time()
    res = {policy: _policy_runs(dev, params, policy, short, long)
           for policy in ("unified", "disagg")}
    for run, n in (("alone", DRAIN_REQUESTS), ("with_long", DRAIN_REQUESTS + DRAIN_LONG)):
        uni, dis = res["unified"]["runs"][run], res["disagg"]["runs"][run]
        wrong = [i for i, (a, b) in enumerate(zip(uni["streams"], dis["streams"])) if a != b]
        if wrong or len(dis["streams"]) != n:
            raise AssertionError(f"disagg run {run}: streams {wrong} differ from unified")
        if (dis["handoffs"], dis["handoff_recompute"]) != (n, 0) or \
                dis["handoff_pages"] != dis["funded_pages"]:
            raise AssertionError(f"disagg run {run}: handoffs {dis['handoffs']}, pages "
                                 f"{dis['handoff_pages']} of {dis['funded_pages']} funded, "
                                 f"recomputes {dis['handoff_recompute']}")
        for policy in ("unified", "disagg"):
            syncs = res[policy]["runs"][run]["syncs"]
            if any(syncs.values()):
                raise AssertionError(f"{policy} run {run}: synchronizing calls {syncs}")
    d = res["disagg"]["runs"]["with_long"]
    out = {
        "handoffs": d["handoffs"], "handoff_pages": d["handoff_pages"],
        "funded_pages": d["funded_pages"], "handoff_recompute": d["handoff_recompute"],
        "handoff_stall_s": d["handoff_stall_s"], "handoff_wait_s": d["handoff_wait_s"],
        "decode_step_ms": {p: {run: res[p]["runs"][run]["decode_step_ms"]
                               for run in ("alone", "with_long")} for p in res},
        "wall_s": time.time() - t0,
    }
    log(f"  (b) disagg streams token-identical to unified ({DRAIN_REQUESTS} requests alone, then "
        f"with {DRAIN_LONG} prompts of {DRAIN_LONG_IDS[0]}-{DRAIN_LONG_IDS[1]} ids submitted while "
        f"they decode; max_batch_size {DRAIN_SLOTS_B}); handoffs {d['handoffs']}, pages handed "
        f"{d['handoff_pages']} = pages funded {d['funded_pages']}, recomputes "
        f"{d['handoff_recompute']}, stall {d['handoff_stall_s']:.4f} s, wait "
        f"{d['handoff_wait_s']:.4f} s; 0 synchronizing calls on either tier's thread; on {smi}")
    for p in res:
        steps = out["decode_step_ms"][p]
        log(f"  (b) decode wall step {p}: {steps['alone']:.3f} ms alone, "
            f"{steps['with_long']:.3f} ms with the long prompts (a record, not a claim); on {smi}")
    return out


class _StubUpstream(BaseHTTPRequestHandler):
    """An upstream in front of the engine server for api_catalog's remote
    backend: answers 503 to its first ``fail`` requests (every request when
    ``fail`` < 0), then relays each to ``upstream`` and streams the answer
    back."""

    fail, hits, upstream = 0, 0, ""

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802 - http.server's naming
        cls = type(self)
        cls.hits += 1
        body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
        if cls.fail < 0 or cls.hits <= cls.fail:
            self.send_response(503)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        req = urllib.request.Request(cls.upstream + self.path, data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.headers.get("Content-Type", ""))
            self.send_header("Connection", "close")
            self.end_headers()
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                self.wfile.write(chunk)
                self.wfile.flush()


# the retrieval tier's dispatches are padded to ann_max_batch rows and the
# synchronous path's single query is not, so a score may differ in its
# last bits (retrieval/ann.py): scores within this, tie runs as sets
SEARCH_SCORE_TOL = 1e-5


def _same_search(a, b) -> bool:
    """Two /search answers (status, body) agree: byte for byte, or the same
    status and chunk count, scores within SEARCH_SCORE_TOL position by
    position, and the same chunks inside each run of scores that lie
    within SEARCH_SCORE_TOL of each other."""
    if a == b:
        return True
    if a[0] != b[0]:
        return False
    ca, cb = json.loads(a[1]).get("chunks", []), json.loads(b[1]).get("chunks", [])
    if len(ca) != len(cb) or any(abs(x["score"] - y["score"]) > SEARCH_SCORE_TOL
                                 for x, y in zip(ca, cb)):
        return False
    key = lambda c: (c["filename"], c["content"])  # noqa: E731
    start = 0
    for end in range(1, len(cb) + 1):
        if end == len(cb) or abs(cb[end - 1]["score"] - cb[end]["score"]) > SEARCH_SCORE_TOL:
            if sorted(map(key, ca[start:end])) != sorted(map(key, cb[start:end])):
                return False
            start = end
    return True


def drain_faults_and_tier(dep, smi) -> dict:
    """Parts (c) and (d) on phase 7's deployment: the retrieval fault, the
    remote LLM's retries and breaker, and the retrieval tier's /search."""
    import os

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import registry, runtime
    from generativeaiexamples_tpu_torch.engine import retrieval_tier
    from generativeaiexamples_tpu_torch.engine import server as engine_server
    from generativeaiexamples_tpu_torch.server.api import GENERIC_ERROR_MSG, make_server
    from generativeaiexamples_tpu_torch.utils import faults, resilience

    t0 = time.time()
    keys = ("EXAMPLE_NAME", "APP_LLM_MODELENGINE", "APP_LLM_SERVERURL", "APP_RETRIEVER_BACKEND")
    saved = {k: os.environ.get(k) for k in keys}
    servers, out = [], {}

    def serve(server):
        thread = threading.Thread(target=server.serve_forever, name="smoke-drain-faults",
                                  daemon=True)
        thread.start()
        servers.append((server, thread))
        return f"http://127.0.0.1:{server.server_address[1]}"

    def restore_env():
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        config_mod.get_config.cache_clear()

    docs, files = dep["corpus"]
    present = set(runtime.get_vector_store("default").sources())
    queries = [docs[k][1] for k in range(RAG_DOCS) if files[k][0] in present][:8]
    try:
        # (c) one injected retrieval failure degrades one answer, as in JAX
        rag = serve(make_server("127.0.0.1", 0, registry.resolve_example("developer_rag")))
        faults.install("retrieval.search:error@1")
        try:
            degraded, _, _ = _generate_stream(rag, queries[0], True, max_tokens=8)
            clean, _, _ = _generate_stream(rag, queries[1], True, max_tokens=8)
        finally:
            faults.reset()
        warned = [f.get("warnings") for f in degraded if f.get("warnings")]
        if not warned or not warned[0][0].startswith(
                "retrieval_degraded: FaultInjected: injected fault at 'retrieval.search'") or \
                degraded[-1]["choices"][0]["finish_reason"] != "[DONE]":
            raise AssertionError(f"(c) the injected retrieval fault did not degrade: {degraded[:2]}")
        if any(f.get("warnings") for f in clean):
            raise AssertionError("(c) the second /generate degraded too")

        # (c) api_catalog's remote backend: 503, 503, then served: 3 attempts
        up = serve(engine_server.make_server("127.0.0.1", 0, engine=dep["engine"]))
        stub = type("Stub", (_StubUpstream,), {"fail": 2, "hits": 0, "upstream": up})
        stub_base = serve(ThreadingHTTPServer(("127.0.0.1", 0), stub))
        os.environ.update(REMOTE_LLM_ENV, APP_LLM_SERVERURL=stub_base)
        config_mod.get_config.cache_clear()
        resilience.reset_breakers()
        cat = serve(make_server("127.0.0.1", 0, registry.resolve_example("api_catalog")))
        r0 = resilience.retries["llm_remote"]
        frames, _, _ = _generate_stream(cat, "What is the catalog?", False, max_tokens=8)
        attempts, retried = stub.hits, resilience.retries["llm_remote"] - r0
        policy = resilience.policy_from_config()
        if frames[-1]["choices"][0]["finish_reason"] != "[DONE]" or \
                GENERIC_ERROR_MSG in _answer(frames) or attempts != policy.max_attempts or \
                retried != 2 or resilience.get_breaker("llm_remote").state != "closed":
            raise AssertionError(f"(c) 503 x2 then served: {attempts} attempts, {retried} "
                                 f"retries, {frames[-1]}")
        # one that keeps failing opens the breaker at the threshold; each
        # /generate answers the one-frame 500 stream, as in JAX
        stub.fail, stub.hits = -1, 0
        threshold = config_mod.get_config().resilience.breaker_failure_threshold
        answers = []
        for _ in range(3):
            status, text = _http(cat, "POST", "/generate", {
                "messages": [{"role": "user", "content": "What is the catalog?"}],
                "use_knowledge_base": False, "max_tokens": 8})
            frames = [json.loads(line[6:]) for line in text.split("\n") if line.startswith("data: ")]
            answers.append((stub.hits, status, _answer(frames)))
        state = resilience.get_breaker("llm_remote").state
        if state != "open" or stub.hits != threshold or answers[-1][0] != answers[-2][0] or \
                any((s, a) != (500, GENERIC_ERROR_MSG) for _, s, a in answers):
            raise AssertionError(f"(c) always failing: breaker {state}, upstream hits and "
                                 f"answers {answers}")
        out["faults"] = {"degraded_warning": warned[0][0], "attempts_to_success": attempts,
                         "retries": retried, "hits_until_open": stub.hits,
                         "breaker_threshold": threshold}
        log(f"  (c) retrieval.search:error@1 degraded one /generate (warnings frame, then the "
            f"LLM-only answer), the next answered clean; api_catalog over a 503, 503, then "
            f"serving upstream answered after {attempts} attempts ({retried} retries, JAX's "
            f"retry_max_attempts {policy.max_attempts}); an always-failing one opened the "
            f"breaker after {stub.hits} failures (threshold {threshold}) and the next /generate "
            f"failed fast without reaching it")
        restore_env()
        resilience.reset_breakers()

        # (d) the retrieval tier: 8 concurrent /search against the synchronous path
        sync = [_http(rag, "POST", "/search", {"query": q, "top_k": 4}) for q in queries]
        os.environ["APP_RETRIEVER_BACKEND"] = "tier"
        config_mod.get_config.cache_clear()
        c0 = dict(retrieval_tier.counters)
        tier = _concurrently({i: lambda q=q: _http(rag, "POST", "/search", {"query": q, "top_k": 4})
                              for i, q in enumerate(queries)})
        c1 = dict(retrieval_tier.counters)
        tier = [tier[i] for i in range(len(queries))]
        if retrieval_tier._TIER is None:
            raise AssertionError("(d) /search did not go through the retrieval tier")
        if any(s != 200 for s, _ in sync):
            raise AssertionError(f"(d) synchronous /search answers {sync}")
        wrong = [i for i, (a, b) in enumerate(zip(tier, sync)) if not _same_search(a, b)]
        if wrong:
            raise AssertionError(f"(d) tier hits differ from the synchronous path's for {wrong}: "
                                 f"{[(tier[i], sync[i]) for i in wrong]}")
        bitwise = sum(a == b for a, b in zip(tier, sync))
        waves = c1.get("waves", 0) - c0.get("waves", 0)
        dispatches = c1.get("dispatches", 0) - c0.get("dispatches", 0)
        queried = c1.get("queries", 0) - c0.get("queries", 0)
        if queried != len(queries) or not dispatches < len(queries):
            raise AssertionError(f"(d) {queried} queries in {waves} waves, {dispatches} dispatches")
        out["tier"] = {"queries": queried, "waves": waves, "dispatches": dispatches,
                       "bitwise_answers": bitwise,
                       "window_wait_s": c1.get("window_wait_seconds", 0.0)
                       - c0.get("window_wait_seconds", 0.0)}
        log(f"  (d) retriever.backend=tier: {queried} concurrent /search answered in {waves} "
            f"waves with {dispatches} ANN dispatches ({dispatches / waves:.2f} a wave), every "
            f"answer equal to the synchronous path's ({bitwise} of {len(queries)} byte for "
            f"byte; the rest within {SEARCH_SCORE_TOL} with tie runs as sets); on {smi}")
    finally:
        faults.reset()
        retrieval_tier.close_tier()
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(60)
        restore_env()
        resilience.reset_breakers()
    out["wall_s"] = time.time() - t0
    return out


def _rag_deploy_ingested(seed, encoders):
    """Phase 7's deployment with phase 7's documents ingested into
    ``default`` (a phase that runs without phase 7)."""
    import os
    import tempfile

    from generativeaiexamples_tpu_torch.chains import runtime

    dep = _rag_deploy(encoders)
    try:
        docs = _rag_corpus(np.random.RandomState(seed + 7))
        files = _rag_files(docs)
        src = tempfile.mkdtemp(dir=dep["tmp"])
        for name, data in files:
            path = os.path.join(src, name)
            with open(path, "wb") as fh:
                fh.write(data)
            runtime.ingest_file(path, name)
    except BaseException:
        _rag_teardown(dep)
        raise
    dep["corpus"] = (docs, files)
    return dep


def phase_drain(dev, smi, seed=0, dep=None, encoders=None) -> dict:
    """Drain and restore, the disagg scheduler, faults and the retrieval
    tier (module docstring, phase 11): ``dep`` is phase 7's deployment,
    still up (this phase takes it down), or None to build one."""
    import tempfile

    t0 = time.time()
    if dep is None:
        dep = _rag_deploy_ingested(seed, encoders)
    try:
        fc = drain_faults_and_tier(dep, smi)
    finally:
        _rag_teardown(dep)
    out = {"faults": fc["faults"], "tier": fc["tier"], "recipes": {}}
    launches = collections.Counter()
    spool_root = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    params = None
    try:
        for name, quantization, kv_dtype, layout, expected in RECIPES:
            if name not in DRAIN_RECIPES:
                continue
            if torch.cuda.is_available():
                log(f"  {name}: {torch.cuda.memory_allocated() / 2**30:.1f} GiB of the card "
                    f"allocated before its engines")
            res, weights = drain_recipe(dev, smi, name, kv_dtype, f"{spool_root}/{name}", seed)
            launches.update(res.pop("launches"))
            out["recipes"][name] = res
            if name == "A":
                params = weights
            del weights
        out["policies"] = drain_policies(dev, smi, params, seed)
    finally:
        import shutil

        shutil.rmtree(spool_root, ignore_errors=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["wall_s"] = time.time() - t0
    log(f"phase drain: ok ({out['wall_s']:.1f} s on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 12: speculative decoding

# recipe A: 6 concurrent greedy requests of 48 tokens a prompt set (96
# until phase 15: the random 1b draft's legs took 77 s of A's 177 s at
# 16 layers), then one seeded request of 24 tokens outside the timed
# window (the JAX bench's _spec_decode_pass, its requests run together
# here); B, C and D (one verify each on another pool or layout) 4
# requests of 64 tokens
SPEC_TRAFFIC = {"A": (6, 48), "B": (4, 64), "C": (4, 64), "D": (4, 64)}
# each recipe's depth (llama3-8b's width, the first layers of A's packs):
# B, C and D at a quarter of its 32 layers since phase 13, A at half since
# phase 15 (phase 12 took 218.3 s with A at full depth, against its budget
# of 150 s)
SPEC_LAYERS = {"A": 8, "B": 8, "C": 8, "D": 8}
SPEC_SEEDED_TOKENS = 24
SPEC_DRAFT_MODEL = "llama3-1b-proxy"
# recipe -> (legs, prompt sets); a leg is (name, proposer or None for off,
# pipelined). A's draft_target leg drafts with llama3-8b whose dense
# weights are the target's packs dequantized (_target_draft): that draft
# accepts, so the draft runtime's catch-up, frontier and rewind are held
# to the off streams. The random 1b-proxy's leg (all drafts rejected, 40
# s of the phase's 98 on the H100) runs in phase 18, where it drafts on
# TP=2 shards
_SPEC_LEGS_A = (("off", None, True), ("lookup", "lookup", True),
                ("lookup_sync", "lookup", False), ("draft_target", "draft_model", True))
_SPEC_LEGS = (("off", None, True), ("lookup", "lookup", True))
SPEC_PLAN = {"A": (_SPEC_LEGS_A, ("copy_heavy", "normal")), "B": (_SPEC_LEGS, ("copy_heavy",)),
             "C": (_SPEC_LEGS, ("copy_heavy",)), "D": (_SPEC_LEGS, ("copy_heavy",))}
SPEC_PROVENANCE = ("uncalibrated: weights_random_init on target/draft - acceptance reflects "
                   "weight coincidence, not a trained draft")


def _spec_prompt(set_name: str, r: int) -> list:
    """Request ``r`` of a prompt set: ``copy_heavy``, the arithmetic ramp
    (512 ids, one chunk: the monolithic prefill) whose greedy decode
    settles into the self-repetition lookup drafts; ``normal``, the
    non-repeating walk over 768 ids (the chunked prefill). Request 0 is
    the JAX bench's prompt, the others shift it by ``r``."""
    if set_name == "copy_heavy":
        return [3 + 10 * i + r for i in range(512)]
    return [(i * 37 + (i * i) % 91 + r) % 199 + 1 for i in range(768)]


class _ShapeLog:
    """Records the shapes the serving path launches the kernels at while
    entered: each paged_attention launch's query rows a slot by pool, each
    int8 matmul launch's M (``pa._launch``, ``im._launch`` and
    ``im._launch_w8a8`` wrapped)."""

    _KV = {torch.bfloat16: "bfloat16", torch.int8: "int8", torch.uint8: "int4"}

    def __enter__(self):
        self.paged, self.int8, self.w8a8 = (collections.Counter() for _ in range(3))
        self._saved = (pa._launch, im._launch, im._launch_w8a8)
        orig_pa, orig_i8, orig_w8 = self._saved

        def pa_launch(q, k, *args):
            self.paged[(self._KV[k.dtype], q.shape[1])] += 1
            return orig_pa(q, k, *args)

        def i8_launch(x2, *args):
            self.int8[x2.shape[0]] += 1
            return orig_i8(x2, *args)

        def w8_launch(x2, *args):
            self.w8a8[x2.shape[0]] += 1
            return orig_w8(x2, *args)

        pa._launch, im._launch, im._launch_w8a8 = pa_launch, i8_launch, w8_launch
        return self

    def __exit__(self, *exc):
        pa._launch, im._launch, im._launch_w8a8 = self._saved
        return False


def _spec_set(engine, name, leg, set_name, trace=True) -> dict:
    """One prompt set on one leg: the recipe's greedy requests together
    (their decode timed on the host clock from the moment each has its
    first token, the device traced over that window), then the seeded
    request alone."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    n_req, n_tok = SPEC_TRAFFIC[name]
    prompts = [_spec_prompt(set_name, r) for r in range(n_req)]
    greedy = SamplingParams(temperature=0.0, max_tokens=n_tok)
    seeded = SamplingParams(temperature=0.7, top_p=0.8, max_tokens=SPEC_SEEDED_TOKENS, seed=1234)
    s0 = engine.stats()
    n_ttft = len(engine._ttft)
    with engine.hold_admissions():
        reqs = [engine.submit(p, greedy) for p in prompts]
    deadline = time.time() + 600
    while not all(r.generated >= 1 or r.finished for r in reqs):
        if time.time() > deadline:
            raise AssertionError(f"spec {name} {leg} {set_name}: no first tokens in 600 s")
        time.sleep(0.001)
    with device_trace.DeviceWindow(trace) as win:
        s1 = engine.stats()
        for r in reqs:
            _drain_ids(r.out_queue)
        s2 = engine.stats()
    if win.result is not None and not win.result["complete"]:
        log(f"    device trace: not measured (it holds {win.result['port_kernels_in_trace']} port "
            f"kernels of the {win.result['port_launches']} launched, "
            f"{win.result['device_events']} device events)")
    outs = [list(r.emitted) for r in reqs]  # the stop token included, as emitted
    ttft = list(engine._ttft)[n_ttft:]
    _settle(engine)
    sampled = [list(engine.iter_ids(prompts[0], seeded, timeout=600))]
    s3 = engine.stats()

    def d(key, a=s0, b=s3):
        return b[key] - a[key]

    dispatches = d("decode_dispatches", s1, s2)
    busy = win.busy_ms
    if busy is not None and busy > win.wall_ms:
        raise AssertionError(f"spec {name} {leg} {set_name}: the device was busy {busy:.3f} ms "
                             f"in a window of {win.wall_ms:.3f} ms")
    return {
        "outs": outs, "sampled": sampled, "prompts": prompts,
        "dispatches": int(d("decode_dispatches")),
        "tokens_per_dispatch": d("tokens_generated", s1, s2) / max(1, dispatches),
        "tokens_per_row_dispatch": d("tokens_generated", s1, s2)
        / max(1, d("decode_row_dispatches", s1, s2)),
        "drafted": int(d("spec_drafted_tokens")), "accepted": int(d("spec_accepted_tokens")),
        "acceptance_rate": d("spec_accepted_tokens") / max(1, d("spec_drafted_tokens")),
        "draft_dispatches": int(d("spec_draft_dispatches")),
        "draft_dispatch_share": d("spec_draft_dispatches", s1, s2)
        / max(1, d("spec_draft_dispatches", s1, s2) + dispatches),
        "verify_dispatches": int(d("spec_verify_dispatches")),
        "block_dispatches": int(d("spec_block_dispatches")),
        "traced": trace,
        "wall_step_ms": win.wall_ms / max(1, dispatches),
        # the trace's device time over the window's target dispatches
        # (a draft proposal's device time included)
        "device_step_ms": None if busy is None else busy / max(1, dispatches),
        "idle_share": None if busy is None else 1.0 - busy / win.wall_ms,
        "device_events": win.events,
        "ttft_s": {"mean": statistics.mean(ttft), "max": max(ttft)} if ttft else None,
    }


def _target_draft(engine):
    """A llama3-8b draft runtime whose dense weights (the engine's dtype:
    bf16) are the target's int8 packs dequantized: it proposes the target's own greedy tokens up
    to the rounding of the two products, so it accepts."""
    from generativeaiexamples_tpu_torch.engine import spec_draft
    from generativeaiexamples_tpu_torch.ops.quant import dequantize_int8

    cfg = engine.model_config
    k_of = {"wqkv": cfg.hidden_size, "w_gateup": cfg.hidden_size, "wo": cfg.q_dim,
            "w_down": cfg.intermediate_size, "lm_head": cfg.hidden_size}

    def dense(key, w):
        return dequantize_int8(w, engine._dtype, k_of[key]) if isinstance(w, dict) else w

    params = {key: dense(key, w) for key, w in engine.params.items() if key != "layers"}
    params["layers"] = [{key: dense(key, w) for key, w in lp.items()}
                        for lp in engine.params["layers"]]
    ec = dataclasses.replace(engine.engine_config,
                             spec_draft_model=engine.engine_config.model_config_name,
                             spec_proposer="draft_model")
    return spec_draft.DraftRuntime(
        ec, device=engine.device, dtype=engine._dtype, sample_vocab=engine._sample_vocab,
        num_slots=engine.num_slots, max_seq_len=engine.max_seq_len, params=params)


def _spec_row_log(name, leg, s, r) -> None:
    ttft = r["ttft_s"] or {"mean": float("nan"), "max": float("nan")}
    device = ("device step not measured" if r["device_step_ms"] is None else
              f"device step {r['device_step_ms']:.3f} ms, idle {r['idle_share']:.1%} "
              f"({r['device_events']} device events traced)") if r["traced"] else "untraced"
    log(f"  {name} {leg:12s} {s:10s}: {r['tokens_per_dispatch']:.3f} tokens a target "
        f"dispatch ({r['tokens_per_row_dispatch']:.3f} a row), acceptance "
        f"{r['acceptance_rate']:.3f} ({r['accepted']}/{r['drafted']}), draft-dispatch "
        f"share {r['draft_dispatch_share']:.3f}, {r['verify_dispatches']} verifies + "
        f"{r['block_dispatches']} zero-draft blocks of {r['dispatches']} dispatches; "
        f"wall step {r['wall_step_ms']:.3f} ms, {device}; TTFT mean {ttft['mean']:.3f} s "
        f"max {ttft['max']:.3f} s")


def _summary(r) -> dict:
    return {k: v for k, v in r.items() if k not in ("outs", "sampled", "prompts")}


def spec_recipe(dev, smi, name, quantization, kv_dtype, layout, params=None,
                model=MODEL) -> tuple:
    """One recipe's legs on one engine of the preset ``model``, toggled
    between legs at runtime (one set of target weights serves every leg):
    every leg's greedy and seeded streams against the ``off`` leg's, each
    set's decode traced."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine

    legs, sets = SPEC_PLAN[name]
    cfg = EngineConfig(model_config_name=model, quantization=quantization, kv_cache_dtype=kv_dtype,
                       kv_layout=layout, max_batch_size=8, max_seq_len=8192, page_size=128,
                       prefill_chunk=512, decode_block=8, tensor_parallelism=1,
                       spec_draft_model=SPEC_DRAFT_MODEL if name == "A" else "")
    t0 = time.time()
    engine = LLMEngine(cfg, device=dev, params=params)
    out = {"legs": {}, "launches": collections.Counter(), "shapes": {}}
    try:
        if engine.device.type == "cuda" and engine._paged and not engine._verify_kernel:
            raise AssertionError(f"spec {name}: the page kernel refuses the verify's rows")
        log(f"  {name}: engine built in {time.time() - t0:.1f} s "
            f"({model}, {quantization} weights, {kv_dtype} {layout} KV, K={engine._spec_draft}; "
            f"{SPEC_TRAFFIC[name][0]} requests x {SPEC_TRAFFIC[name][1]} tokens a set)")
        ref = None
        for leg, proposer, pipelined in legs:
            _settle(engine)
            if leg == "draft_target":
                t_build = time.time()
                engine._draft = _target_draft(engine)
                log(f"  {name} {leg}: llama3-8b draft from the dequantized packs built in "
                    f"{time.time() - t_build:.1f} s")
            if proposer is None:
                engine.set_spec_decode(False)
            else:
                if not engine.set_spec_decode(True):
                    raise AssertionError(f"spec {name}: set_spec_decode(True) refused")
                if engine.set_spec_proposer(proposer) != proposer:
                    raise AssertionError(f"spec {name}: proposer {proposer} not served")
            engine._spec_pipeline = pipelined  # read by the dispatch thread each round
            reset_counts()
            t_leg = time.time()
            with SyncCounter() as syncs, _ShapeLog() as shapes:
                # a leg's first set traced: a trace costs seconds of host
                # time a window
                res = {s: _spec_set(engine, name, leg, s, trace=s == sets[0]) for s in sets}
                _settle(engine)
            launched = counts()
            out["launches"].update(launched)
            dispatch = {k: v for (th, k), v in syncs.kinds.items() if th == "torch-llm-engine"}
            if dispatch.get(None, 0):
                raise AssertionError(f"spec {name} {leg}: {dispatch[None]} synchronizing calls on "
                                     f"the dispatch thread outside the spec read backs")
            ties = 0
            if ref is None:
                ref = res
            else:
                for s in sets:
                    for i, (got, want) in enumerate(zip(res[s]["outs"] + res[s]["sampled"],
                                                        ref[s]["outs"] + ref[s]["sampled"])):
                        prompt = res[s]["prompts"][i if i < len(res[s]["outs"]) else 0]
                        ties += _tie_checked(engine, f"{name} {leg} {s} stream {i}", prompt,
                                             got, want)
            if proposer is not None:
                if dispatch.get("spec", 0) == 0:
                    raise AssertionError(f"spec {name} {leg}: no spec read back on the dispatch thread")
                if sum(r["verify_dispatches"] for r in res.values()) == 0:
                    raise AssertionError(f"spec {name} {leg}: no verify dispatched")
            if leg == "lookup" and res["copy_heavy"]["accepted"] < 1:
                raise AssertionError(f"spec {name}: lookup accepted no draft on copy_heavy")
            if proposer == "draft_model" and sum(r["draft_dispatches"] for r in res.values()) == 0:
                raise AssertionError(f"spec {name} {leg}: the draft model dispatched nothing")
            if leg == "draft_target":
                for s, r in res.items():
                    if r["accepted"] < 1:
                        raise AssertionError(f"spec {name} {leg} {s}: the target's own weights "
                                             f"as the draft accepted nothing")
            verify_T = sorted({t for (kv, t), n in shapes.paged.items() if t > 1})
            out["shapes"][leg] = {
                "paged_T": {f"{kv}:T{t}": n for (kv, t), n in sorted(shapes.paged.items())},
                "int8_matmul_M": dict(sorted(shapes.int8.items())),
                "int8_w8a8_matmul_M": dict(sorted(shapes.w8a8.items())),
            }
            out["legs"][leg] = {"ties": ties, "launches": {k: v for k, v in launched.items() if v},
                                "dispatch_syncs": {str(k): v for k, v in dispatch.items()},
                                **{s: _summary(r) for s, r in res.items()}}
            for s, r in res.items():
                _spec_row_log(name, leg, s, r)
            log(f"  {name} {leg}: launches {out['legs'][leg]['launches']}; verify query rows "
                f"{verify_T or 'none'}; int8 matmul M {sorted(shapes.int8) or '-'}, w8a8 M "
                f"{sorted(shapes.w8a8) or '-'}; dispatch-thread syncs by kind {dispatch or 'none'}; "
                f"streams {'the reference' if leg == 'off' else 'equal to off'}"
                f"{f' ({ties} parted at a tie)' if ties else ''}; {time.time() - t_leg:.1f} s on {smi}")
            if name == "A" and leg == "off":
                # the trace's cost: the first set again, untraced
                _settle(engine)
                r = _spec_set(engine, name, "off_untraced", sets[0], trace=False)
                for i, (got, want) in enumerate(zip(r["outs"] + r["sampled"],
                                                    ref[sets[0]]["outs"] + ref[sets[0]]["sampled"])):
                    _tie_checked(engine, f"{name} off untraced stream {i}",
                                 r["prompts"][i if i < len(r["outs"]) else 0], got, want)
                out["legs"]["off_untraced"] = {sets[0]: _summary(r)}
                _spec_row_log(name, "off_untraced", sets[0], r)
        weights = engine.params
    finally:
        engine.shutdown()
        _free_engine(engine)
        engine._draft = engine._spec_proposer = None
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t0
    return out, weights


def phase_spec(dev, smi) -> dict:
    """Speculative decoding at full llama3-8b (module docstring, phase 12)."""
    from generativeaiexamples_tpu_torch.models import llama

    t0 = time.time()
    out = {"recipes": {}, "provenance": SPEC_PROVENANCE}
    launches = collections.Counter()
    weights = None
    for name, quantization, kv_dtype, layout, _ in RECIPES:
        # A, C and D share int8 packs; B (w8a8) serves the same packs; each
        # recipe takes the first SPEC_LAYERS of A's
        layers = SPEC_LAYERS[name]
        model = _cut_model(layers)
        if weights is not None:
            weights = dict(weights, layers=weights["layers"][:layers])
        res, weights = spec_recipe(dev, smi, name, quantization, kv_dtype, layout, weights,
                                   model=model)
        launches.update(res.pop("launches"))
        out["recipes"][name] = res
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["wall_s"] = time.time() - t0
    log(f"  provenance: {SPEC_PROVENANCE}; layers of {llama.PRESETS[MODEL].num_layers} by "
        f"recipe {SPEC_LAYERS}")
    log(f"phase spec: ok ({out['wall_s']:.1f} s on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 13: observability

# recipe A through both servers, everything the JAX defaults switch on
OBSERVE_ENV = {
    "EXAMPLE_NAME": "developer_rag",
    "APP_LLM_MODELENGINE": "tpu",
    "APP_EMBEDDINGS_MODELENGINE": "hash",
    "APP_ENGINE_MODELCONFIGNAME": MODEL,
    "APP_ENGINE_QUANTIZATION": "int8",
    "APP_ENGINE_KVCACHEDTYPE": "bfloat16",
    "APP_ENGINE_KVLAYOUT": "paged",
    "APP_ENGINE_TENSORPARALLELISM": "1",
}
OBSERVE_REQUESTS, OBSERVE_TOKENS = 8, 64  # /generate requests (4 at a time) x tokens
OBSERVE_PROFILE_TOKENS = 8  # each of the 2 profiled requests: one decode block
OBSERVE_PROFILE_TRIES = 3  # CUPTI can drop a session's events: capture again
OBSERVE_CHILD_S = 600  # the time limit of the phase's process
OBSERVE_PAIRS, OBSERVE_BATCH = 3, (8, 64)  # host-cost pairs; greedy requests x tokens a batch
OBSERVE_METERED = 2  # batches of the observed engine under _HostCostMeter
# a /generate record's events from the request to its end, in JAX's order
OBSERVE_CHAIN = ("http_request", "admitted", "submit", "admit", "page_alloc", "prefill_wave",
                 "decode_join", "first_token", "engine_finish", "finish")
OBSERVE_KERNELS = ("int8_matmul_mma", "paged_(split|merge)_kernel", "flash_attention_kernel")
OBSERVE_WORDS = ("page", "pool", "token", "slot", "kernel", "batch", "prefix", "cache", "decode",
                 "wave", "chunk", "layer", "head", "score", "span", "trace")


def _observe_query(rng) -> str:
    """A question of 30-45 words: with ``developer_rag``'s system prompt
    and the chat template, under the 512-id prefill bucket (60 words make
    about 512 byte ids), so its prefill is one monolithic wave (the flash
    kernel's)."""
    return " ".join(rng.choice(OBSERVE_WORDS, size=rng.randint(30, 46)))


def _metric_value(text: str, name: str) -> float:
    """An unlabeled sample's value in a text exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics has no sample {name}")


def _observe_batch(engine, prompts, tokens) -> dict:
    """One held wave of greedy requests: the reader's decode wall time a
    block (the wall step) and the batch's wall time."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    s0 = engine.stats()
    t0 = time.perf_counter()
    with engine.hold_admissions():
        reqs = [engine.submit(p, SamplingParams(temperature=0.0, max_tokens=tokens))
                for p in prompts]
    outs = [_drain_ids(r.out_queue) for r in reqs]
    wall = time.perf_counter() - t0
    s1 = engine.stats()
    blocks = s1["decode_blocks"] - s0["decode_blocks"]
    return {"outs": outs, "batch_s": wall, "blocks": blocks,
            "dispatches": s1["decode_dispatches"] - s0["decode_dispatches"],
            "tokens": s1["tokens_generated"] - s0["tokens_generated"],
            "wall_step_ms": (s1["decode_time_s"] - s0["decode_time_s"]) / max(1, blocks) * 1e3}


class _HostCostMeter:
    """The host time spent inside the port's observability calls while the
    meter is open, by thread: metric updates (counters, gauges, histograms,
    label lookups), flight-recorder events, SLO samples, dispatch-timeline
    spans, telemetry records and ``record_function`` labels. Each entry
    point is wrapped by a timer; only the outermost instrument call on a
    thread is timed (one that calls another counts once). The wrapper's own
    two clock reads fall inside what it times; the arguments the engine
    builds for a call (a span's rid list, ``time.time()``) fall outside."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.by_entry = collections.Counter()  # (thread, entry point) -> seconds
        self._local = threading.local()
        self._saved = []

    @staticmethod
    def _targets():
        from torch.profiler import record_function

        from generativeaiexamples_tpu_torch.engine import dispatch_timeline, telemetry
        from generativeaiexamples_tpu_torch.utils import flight_recorder, slo
        from generativeaiexamples_tpu_torch.utils import metrics as m

        return [
            (m._CounterChild, ("inc",)), (m._GaugeChild, ("set", "inc", "dec")),
            (m._HistogramChild, ("observe",)), (m._MetricFamily, ("labels",)),
            (m.Counter, ("inc",)), (m.Gauge, ("set", "inc", "dec")), (m.Histogram, ("observe",)),
            (flight_recorder, ("start", "current", "event", "map_rid", "event_rid", "finish",
                               "finish_rid")),
            (flight_recorder.RequestRecord, ("event",)),
            (slo, ("observe_latency", "observe_event")),
            (dispatch_timeline, ("record_span", "record_stall", "record_readback",
                                 "record_pipeline_flush", "record_rollback")),
            (telemetry.UtilizationEstimator, ("record_dispatch", "record_readback")),
            (record_function, ("__init__", "__enter__", "__exit__")),
        ]

    def _timed(self, fn, entry):
        local, seconds, calls, by_entry = self._local, self.seconds, self.calls, self.by_entry

        def timed(*args, **kwargs):
            if getattr(local, "inside", False):
                return fn(*args, **kwargs)
            local.inside = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                took = time.perf_counter() - t0
                name = threading.current_thread().name
                seconds[name] += took
                calls[name] += 1
                by_entry[name, entry] += took
                local.inside = False

        return timed

    def __enter__(self):
        for owner, attrs in self._targets():
            for attr in attrs:
                fn = owner.__dict__[attr]
                self._saved.append((owner, attr, fn))
                setattr(owner, attr, self._timed(fn, f"{owner.__name__.rsplit('.', 1)[-1]}.{attr}"))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()
        return False


def phase_observe(dev, smi, seed=0) -> dict:
    """Observability at full llama3-8b, recipe A (module docstring, phase
    13): a fresh engine behind both servers with tracing into a JSONL
    file and profiling on, then the host-cost pair."""
    import os
    import shutil
    import tempfile

    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot
    from generativeaiexamples_tpu_torch.config import get_config
    from generativeaiexamples_tpu_torch.engine import dispatch_timeline, llm_engine
    from generativeaiexamples_tpu_torch.engine import server as engine_server
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.server.api import make_server
    from generativeaiexamples_tpu_torch.utils import flight_recorder, tracing
    from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    spans_path = os.path.join(tmp, "spans.jsonl")
    env = dict(OBSERVE_ENV, ENABLE_TRACING="true", TRACE_EXPORTER="jsonl",
               TRACE_JSONL_PATH=spans_path, ENABLE_PROFILING="true",
               PROFILE_LOG_DIR=os.path.join(tmp, "profiles"),
               APP_VECTORSTORE_PERSISTDIR=os.path.join(tmp, "store"),
               APP_BLACKBOX_DIR=os.path.join(tmp, "blackbox"))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    get_config.cache_clear()
    runtime.reset_runtime()
    runtime.set_device(None)
    tracing.reset_tracer()  # rebuilt on first use: a Tracer exporting to spans_path
    flight_recorder.reset()
    dispatch_timeline.reset()
    dispatch_timeline.configure(enable=True)
    registry = metrics_mod.get_registry()
    rng = np.random.RandomState(seed + 13)
    servers, engines, out = [], [], {"smi": smi}
    try:
        params = quant.init_packed_params_int8(llama.PRESETS[MODEL], seed, torch.bfloat16, dev)
        ecfg = EngineConfig(model_config_name=MODEL, quantization="int8",
                            kv_cache_dtype="bfloat16", kv_layout="paged", tensor_parallelism=1)
        t_build = time.time()
        # built with the timeline on and ENABLE_PROFILING set: both resolve at init
        engine = LLMEngine(ecfg, device=dev, params=params)
        engines.append(engine)
        out["engine_build_s"] = time.time() - t_build
        with llm_engine._ENGINE_LOCK:
            llm_engine._ENGINE = engine
        # make_server validates and configures the observability sections
        for srv in (make_server("127.0.0.1", 0, QAChatbot),
                    engine_server.make_server("127.0.0.1", 0, engine=engine)):
            th = threading.Thread(target=srv.serve_forever, name="smoke-observe-server",
                                  daemon=True)
            th.start()
            servers.append((srv, th))
        chain_base, model_base = (f"http://127.0.0.1:{srv.server_address[1]}"
                                  for srv, _ in servers)
        ttft0 = registry.get("genai_engine_ttft_seconds").count
        req0 = registry.get("genai_engine_requests_total").value
        reset_counts()
        with SyncCounter() as syncs:
            # 1. 8 /generate, 4 at a time, each with its own traceparent
            traces = ["".join(f"{x:08x}" for x in rng.randint(1, 2**31, size=4))
                      for _ in range(OBSERVE_REQUESTS)]
            queries = [_observe_query(rng) for _ in traces]
            ttfts = []
            for wave in (range(0, 4), range(4, OBSERVE_REQUESTS)):
                res = _concurrently({
                    str(i): (lambda i=i: _generate_stream(
                        chain_base, queries[i], False, OBSERVE_TOKENS,
                        headers={"traceparent": f"00-{traces[i]}-00f067aa0ba902b7-01"}))
                    for i in wave})
                for i in wave:
                    frames, first, _ = res[str(i)]
                    if (frames[-1].get("choices") or [{}])[0].get("finish_reason") != "[DONE]":
                        raise AssertionError(f"/generate {i} did not end with [DONE]: {frames[-1]}")
                    ttfts.append(first)
            # 2. /metrics in both formats on both servers
            names = {f.name for f in registry.families()}
            finished = registry.get("genai_engine_ttft_seconds").count - ttft0
            submitted = registry.get("genai_engine_requests_total").value - req0
            exemplars = set()
            for base in (chain_base, model_base):
                for om in (False, True):
                    req = urllib.request.Request(base + "/metrics", headers={
                        "Accept": "application/openmetrics-text" if om else "text/plain"})
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        ctype, text = resp.headers["Content-Type"], resp.read().decode()
                    if om != ctype.startswith("application/openmetrics-text"):
                        raise AssertionError(f"{base}/metrics answered {ctype}")
                    fams = {line.split()[2] for line in text.splitlines()
                            if line.startswith("# TYPE ")}
                    fams = {n if n in names else n + "_total" for n in fams}
                    if fams != names:
                        raise AssertionError(f"/metrics families differ from the registry's: "
                                             f"{sorted(fams ^ names)}")
                    count = _metric_value(text, "genai_engine_ttft_seconds_count") - ttft0
                    if count != finished or finished != OBSERVE_REQUESTS:
                        raise AssertionError(f"TTFT count {count}, engine finished {finished}, "
                                             f"sent {OBSERVE_REQUESTS}")
                    if om:
                        exemplars |= set(re.findall(r'# \{trace_id="([0-9a-f]{32})"\}', text))
                    else:
                        out["mfu_ratio"] = _metric_value(text, "genai_engine_mfu_ratio")
                        out["hbm_bw_ratio"] = _metric_value(text, "genai_engine_hbm_bw_ratio")
            tracing.get_tracer().force_flush()
            with open(spans_path) as fh:
                exported = {json.loads(line)["trace_id"] for line in fh if line.strip()}
            linked = exemplars & exported & set(traces)
            if not linked:
                raise AssertionError(f"no exemplar trace id is a sent and exported trace: "
                                     f"{len(exemplars)} exemplars, {len(exported)} exported")
            log(f"  /metrics: {len(names)} genai_ families on both servers in both formats; "
                f"TTFT count {finished:.0f} = requests finished ({submitted:.0f} submitted); "
                f"{len(linked)} exemplar trace ids are sent traceparents in the JSONL export "
                f"({len(exported)} traces exported)")
            # 3. one request's timeline, JAX's chain in order
            status, text = _http(chain_base, "GET", f"/internal/requests?trace={traces[0]}")
            (tl,) = json.loads(text)["timelines"]
            status, text = _http(chain_base, "GET", f"/internal/requests/{tl['request_id']}")
            events = [e["event"] for e in json.loads(text)["timeline"]]
            it = iter(events)
            if status != 200 or not all(kind in it for kind in OBSERVE_CHAIN):
                raise AssertionError(f"request timeline {events} lacks JAX's chain {OBSERVE_CHAIN}")
            log(f"  /internal/requests/{{id}}: {' -> '.join(events)}")
            # 4. the dispatch timeline as a Chrome trace, and its bubble
            status, text = _http(chain_base, "GET",
                                 "/internal/timeline?format=perfetto&limit=4096")
            trace_doc = json.loads(text)
            dispatches = [e for e in trace_doc["traceEvents"]
                          if e.get("ph") == "X" and e.get("cat") == "dispatch"]
            status, text = _http(chain_base, "GET", "/internal/timeline?limit=4096")
            tl_doc = json.loads(text)
            bubble = tl_doc["bubble"]
            # the four shares recomputed from the served spans, over the spans of
            # the served bubble's window (the newest n by their end, compiles
            # left out), each held to the served share it rounds to 4 digits
            spans = sorted((sp for sp in tl_doc["spans"] if sp["category"] != "compile"),
                           key=lambda sp: sp["t_wall"] + sp["lock_wait_s"]
                           + sp.get("launch_s", sp.get("device_est_s", 0.0)))
            n_win = bubble.get("bubble_spans_in_window", 0)
            if len(tl_doc["spans"]) >= 4096 or not 0 < n_win <= len(spans):
                raise AssertionError(f"timeline: {len(tl_doc['spans'])} spans served, the "
                                     f"bubble's window holds {n_win}")
            comp = {"device": 0.0, "lock": 0.0, "gap": 0.0, "readback": 0.0}
            for sp in spans[len(spans) - n_win:]:
                run = sp.get("launch_s", sp.get("device_est_s", 0.0))
                if sp["category"] == "dispatch":
                    comp["device"] += run
                    comp["lock"] += sp["lock_wait_s"]
                    comp["gap"] += sp["gap_s"]
                elif sp["category"] == "stall":
                    comp["gap"] += run
                elif sp["category"] == "readback":
                    comp["readback"] += run
            total = sum(comp.values())
            fractions = {k: v / total for k, v in comp.items()}
            # 4-digit rounding of a share, plus the span views' 6-digit rounding
            # (up to 3 terms of 5e-7 s a span) over the active wall, twice
            tol = 5e-5 + 2 * 3 * 5e-7 * n_win / total
            diffs = {k: abs(fractions[k] - bubble[f"bubble_{k}_ratio"]) for k in comp}
            if not dispatches or max(diffs.values()) > tol or \
                    bubble.get("bubble_run_kind") != "launch":
                raise AssertionError(f"timeline: {len(dispatches)} dispatch spans, shares "
                                     f"{fractions} against the served {bubble} (tolerance "
                                     f"{tol:.3g})")
            out["bubble"] = {k: round(v, 6) for k, v in fractions.items()}
            log(f"  /internal/timeline: {len(dispatches)} dispatch spans in the Chrome trace; "
                f"shares of the engine's active wall over the window's {n_win} spans: "
                + ", ".join(f"{k} {v:.6f} (served {bubble[f'bubble_{k}_ratio']:.4f})"
                            for k, v in fractions.items())
                + f", each within {tol:.3g} of the served share; 'device' is launch time on "
                f"the card")
            # 5. a profile over 2 requests through the routes
            captures = []
            for attempt in range(1, OBSERVE_PROFILE_TRIES + 1):
                pair = [_observe_query(rng) for _ in range(2)]
                status, text = _http(chain_base, "POST", "/internal/profile/start", raw=b"")
                if status != 200:
                    raise AssertionError(f"/internal/profile/start: {status} {text}")
                _concurrently({str(i): (lambda i=i: _generate_stream(
                    chain_base, pair[i], False, OBSERVE_PROFILE_TOKENS)) for i in range(2)})
                status, text = _http(chain_base, "POST", "/internal/profile/stop", raw=b"")
                prof = json.loads(text)
                if status != 200:
                    raise AssertionError(f"/internal/profile/stop: {status} {text}")
                names_seen = {n for n, _, _ in device_trace.chrome_trace_events(prof["trace"])}
                found = {k: any(re.search(k, n) for n in names_seen) for k in OBSERVE_KERNELS}
                captures.append(
                    f"profile {attempt}: complete {prof['complete']} ({prof['port_kernels_in_trace']} "
                    f"port kernels in the trace of {prof['port_launches']} launched; by kernel "
                    f"{prof['kernels_in_trace']} in the trace of {prof['kernels_launched']} "
                    f"launched; {prof['device_events']} device events; not measured: "
                    f"{prof['not_measured']}); kernels {found}")
                log(f"  {captures[-1]}")
                busy = prof["busy_ms"]
                if all(found.values()) and prof["complete"] and busy is not None:
                    if busy > prof["wall_ms"]:
                        raise AssertionError(f"profile: busy {busy} ms over a wall of "
                                             f"{prof['wall_ms']} ms")
                    break
            else:
                raise AssertionError(f"no complete, measured profile holding {OBSERVE_KERNELS} "
                                     f"in {OBSERVE_PROFILE_TRIES} captures: {captures}")
            out["profile"] = {k: prof[k] for k in ("complete", "port_kernels_in_trace",
                                                   "port_launches", "kernels_in_trace",
                                                   "kernels_launched", "device_events", "busy_ms",
                                                   "wall_ms", "idle_share", "kernels_ms")}
            out["profile"]["captures"] = attempt
            by_name = collections.Counter()
            for name, a, b in device_trace.chrome_trace_events(prof["trace"]):
                by_name[name[:60]] += (b - a) / 1e3
            out["profile"]["top_kernels_ms"] = dict(by_name.most_common(8))
            log(f"  profile: the 8 kernels with the most device time (ms): "
                f"{out['profile']['top_kernels_ms']}")
            log(f"  profile: busy {prof['busy_ms']} ms of {prof['wall_ms']} ms wall, idle share "
                f"{prof['idle_share']}; device ms by kernel {prof['kernels_ms']} on {smi}")
            status, text = _http(chain_base, "GET", "/internal/timeline?format=perfetto&trace="
                                 + urllib.parse.quote(prof["trace"]))
            overlay = [e for e in json.loads(text)["traceEvents"]
                       if e.get("pid") == dispatch_timeline._PID_DEVICE_TRACE and e.get("ph") == "X"]
            if not overlay:
                raise AssertionError("the timeline did not overlay the profile's kernel spans")
            log(f"  /internal/timeline?trace=: {len(overlay)} measured kernel spans on the "
                f"device track")
        # 6. telemetry against one H100's peaks, beside the card's limit
        if not (0 < out["mfu_ratio"] <= 1.05 and 0 < out["hbm_bw_ratio"] <= 1.05):
            raise AssertionError(f"telemetry out of (0, 1.05]: mfu {out['mfu_ratio']}, "
                                 f"hbm {out['hbm_bw_ratio']}")
        log(f"  genai_engine_mfu_ratio {out['mfu_ratio']:.5f}, genai_engine_hbm_bw_ratio "
            f"{out['hbm_bw_ratio']:.5f} (rolling 10 s, the host's dispatch records against "
            f"989 TFLOP/s and 3.35 TB/s) on {smi}")
        # 7. the dispatch thread's synchronizing calls over steps 1-5
        out["dispatch_syncs"] = syncs.counts.get("torch-llm-engine", 0)
        if out["dispatch_syncs"]:
            raise AssertionError(f"the dispatch thread synchronized: {dict(syncs.counts)}")
        log(f"  synchronizing calls by thread over steps 1-5: {dict(syncs.counts)} "
            f"(dispatch thread: 0)")
        out["ttft_s"] = {"mean": statistics.mean(ttfts), "max": max(ttfts)}
        log(f"  /generate TTFT mean {out['ttft_s']['mean']:.3f} s, max {out['ttft_s']['max']:.3f} s "
            f"(8 at concurrency 4, <= 512 ids, the server's default sampling)")
        # 8. host cost: the defaults against everything off, 3 pairs in turns
        for srv, th in servers:
            srv.shutdown()
            srv.server_close()
            th.join(30)
        servers.clear()
        on_tracer = tracing.get_tracer()
        os.environ.pop("ENABLE_PROFILING")
        dispatch_timeline.configure(enable=False)
        engine_off = LLMEngine(ecfg, device=dev, params=params)
        engines.append(engine_off)
        dispatch_timeline.configure(enable=True)
        n, tokens = OBSERVE_BATCH
        prompts = [[int(x) for x in rng.randint(3, 500, size=rng.randint(101, 158))]
                   for _ in range(n)]
        legs = {"on": [], "off": []}
        streams = {}
        for pair in range(OBSERVE_PAIRS):
            for leg in (("on", "off") if pair % 2 == 0 else ("off", "on")):
                on = leg == "on"
                flight_recorder.configure(enable=on)
                with tracing._TRACER_LOCK:
                    tracing._TRACER = on_tracer if on else tracing.NoopTracer()
                res = _observe_batch(engine if on else engine_off, prompts, tokens)
                legs[leg].append(res)
                streams.setdefault(leg, res["outs"])
        flight_recorder.configure(enable=True)
        with tracing._TRACER_LOCK:
            tracing._TRACER = on_tracer
        out["host_cost"] = {}
        for leg, runs in legs.items():
            steps = [r["wall_step_ms"] for r in runs]
            out["host_cost"][leg] = {"wall_step_ms": steps, "median": statistics.median(steps),
                                     "spread": max(steps) - min(steps),
                                     "batch_s": [r["batch_s"] for r in runs]}
        on_m, off_m = (out["host_cost"][k]["median"] for k in ("on", "off"))
        log(f"  host cost, {OBSERVE_PAIRS} pairs of {n} greedy x {tokens} tokens in turns: wall "
            f"step (a block of {ecfg.decode_block}) everything on {on_m:.2f} ms (spread "
            f"{out['host_cost']['on']['spread']:.2f}), flight recorder, timeline, tracing and "
            f"profiling off {off_m:.2f} ms (spread {out['host_cost']['off']['spread']:.2f}), "
            f"on - off {on_m - off_m:+.2f} ms; streams equal: {streams['on'] == streams['off']} "
            f"on {smi}")
        # the instruments' own host time on the observed engine, every one on
        # (metrics and SLO included, which the off leg keeps too)
        metered = []
        with _HostCostMeter() as meter:
            for _ in range(OBSERVE_METERED):
                metered.append(_observe_batch(engine, prompts, tokens))
        blocks = sum(r["blocks"] for r in metered)
        dispatches = sum(r["dispatches"] for r in metered)
        toks = sum(r["tokens"] for r in metered)
        sec = dict(meter.seconds)
        disp_s = sec.get("torch-llm-engine", 0.0)
        read_s = sec.get("torch-llm-reader", 0.0)
        step_ms = statistics.median(r["wall_step_ms"] for r in metered)
        per_block_ms = (disp_s + read_s) / max(1, blocks) * 1e3
        top = {th: dict([(e, round(v * 1e3, 3)) for (t, e), v in meter.by_entry.most_common()
                         if t == th][:6]) for th in ("torch-llm-engine", "torch-llm-reader")}
        out["host_cost"]["metered"] = {
            "batches": OBSERVE_METERED, "decode_blocks": blocks, "decode_dispatches": dispatches,
            "tokens": toks, "seconds_by_thread": sec, "calls_by_thread": dict(meter.calls),
            "dispatch_us_per_dispatch": disp_s / max(1, dispatches) * 1e6,
            "reader_us_per_token": read_s / max(1, toks) * 1e6,
            "ms_per_block": per_block_ms, "wall_step_ms": step_ms,
            "share_of_wall_step": per_block_ms / step_ms, "top_entries_ms": top,
        }
        log(f"  host cost, metered ({OBSERVE_METERED} batches on the observed engine, every "
            f"instrument timed): dispatch thread {disp_s * 1e3:.3f} ms over {dispatches} "
            f"dispatches ({disp_s / max(1, dispatches) * 1e6:.1f} us each, "
            f"{meter.calls['torch-llm-engine']} calls), reader {read_s * 1e3:.3f} ms over {toks} "
            f"tokens ({read_s / max(1, toks) * 1e6:.2f} us each, "
            f"{meter.calls['torch-llm-reader']} calls); the two threads {per_block_ms:.3f} ms a "
            f"block against a wall step of {step_ms:.2f} ms ({per_block_ms / step_ms:.2%}); "
            f"other threads {({k: round(v * 1e3, 3) for k, v in sec.items() if not k.startswith('torch-llm-')})} "
            f"ms; the entry points with the most time (ms): {top}; streams equal the observed "
            f"leg's: "
            f"{all(r['outs'] == streams['on'] for r in metered)} on {smi}")
        out["launches"] = counts()
        log(f"  launches in phase observe: {out['launches']}")
        for name in RECIPES[0][4]:
            if out["launches"].get(name, 0) < 1:
                raise AssertionError(f"phase observe launched no {name}: {out['launches']}")
    finally:
        for srv, th in servers:
            srv.shutdown()
            srv.server_close()
            th.join(30)
        for eng in engines:
            eng.shutdown()
            _free_engine(eng)
        with llm_engine._ENGINE_LOCK:
            llm_engine._ENGINE = None
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        tracing.reset_tracer()
        flight_recorder.reset()
        dispatch_timeline.configure(enable=True)
        runtime.reset_runtime()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t0
    log(f"phase observe: ok ({out['wall_s']:.1f} s on {smi}; engine build "
        f"{out['engine_build_s']:.1f} s)")
    return out


def _in_child(flag, phase, seed, limit) -> dict:
    """One phase in a child process of this script (``flag``): its
    profile starts from a fresh CUPTI state, where after this process's
    earlier profiler sessions whole captures came back without their
    kernels, or short of one. Its log lines are relayed and its standard
    error passes through; a child that fails fails the phase."""
    cmd = [sys.executable, os.path.abspath(__file__), flag, "--seed", str(seed)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=limit)
    lines = proc.stdout.splitlines()
    for line in lines if proc.returncode else lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase {phase}: its process exited {proc.returncode}")
    return json.loads(lines[-1])


# --------------------------------------------------------------------- #
# Phase 14: the router

# each replica is phase 7's deployment, traced (the stitched trace) and
# profilable (the kernel check inside the replica), loading a bf16
# checkpoint of CUT_LAYERS layers written by the phase
# (APP_ENGINE_CHECKPOINTPATH: its config.json is the model)
ROUTE_REPLICA_ENV = dict(RAG_ENV, ENABLE_TRACING="true", TRACE_EXPORTER="memory",
                         ENABLE_PROFILING="true")
# the router: one rate-limited tenant; bounded-load spill held off, since the
# phase checks placement by the ring itself (tests/test_torch_router.py holds
# the spill walk to JAX's)
ROUTE_ROUTER_ENV = {"APP_ROUTER_TENANTS": "limited:rate=1,burst=1", "APP_ROUTER_LOADBOUND": "0",
                    "ENABLE_TRACING": "true", "TRACE_EXPORTER": "memory"}
ROUTE_REPLICA_ARGS = ()  # extra arguments of each replica's command line
ROUTE_MIN_FREE_GB = 40.0  # two replicas of ~18 GB each
# The chain server floors temperature and top_p at 0.1: at top_p 0.1 the
# nucleus is the top token alone wherever it holds a tenth of the mass
# (random llama3-8b logits have a std near 1, so at temperature 0.1 the
# top token holds most of it), which makes these requests greedy.
ROUTE_SAMPLING = {"temperature": 0.1, "top_p": 0.1}
ROUTE_CONVERSATIONS, ROUTE_TURNS, ROUTE_CONCURRENCY, ROUTE_TURN_TOKENS = 8, 3, 4, 32
ROUTE_FIRST_CHARS = 1100  # a first message's least length (byte ids): >= 2 shared chunks
ROUTE_DOCS = 4  # phase 7's documents ingested through the router
ROUTE_DRAIN_STREAMS, ROUTE_KILL_STREAMS, ROUTE_STREAM_TOKENS = 4, 2, 64
ROUTE_TTFT_PAIRS = 4  # short requests through the router and straight to a replica
ROUTE_BUDGET_S = 150.0
ROUTE_MID_TOKENS = 16  # tokens a stream has decoded when its replica drains or dies
# what the replica's wrappers must have launched in the profiled window
ROUTE_LAUNCHED = ("int8_matmul_mma", "paged_split_kernel", "flash_attention_kernel")
ROUTE_WORDS = OBSERVE_WORDS + ("router", "replica", "ring", "owner", "tenant", "fleet",
                               "drain", "restore")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _route_text(rng, chars, tag) -> str:
    words, n = [tag], len(tag)
    while n < chars:
        words.append(str(rng.choice(ROUTE_WORDS)))
        n += len(words[-1]) + 1
    return " ".join(words)


def _owned_by(rng, owner, chars, tag, count) -> list:
    """``count`` messages of at least ``chars`` characters whose ring owner
    (the port's HashRing over r0, r1) is ``owner``."""
    from generativeaiexamples_tpu_torch.router.ring import HashRing

    ring, out = HashRing(["r0", "r1"]), []
    while len(out) < count:
        text = _route_text(rng, chars, f"{tag} {len(out)}-{int(rng.randint(1 << 30))}:")
        if ring.owner(text) == owner:
            out.append(text)
    return out


def _route_stream(base, message, tokens, history=(), headers=None, path="/generate") -> dict:
    """One streamed chat through ``base``: the text, the replica header,
    the seconds to the first answer frame, the longest gap between two
    frames, the finish reasons seen, and the client's next messages."""
    messages = list(history) + [{"role": "user", "content": message}]
    body = {"messages": messages, "use_knowledge_base": False, "max_tokens": tokens,
            **ROUTE_SAMPLING}
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    texts, stamps, finishes, first = [], [], [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        replica = resp.headers.get("X-GenAI-Replica")
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if not line.startswith("data: "):
                continue
            stamps.append(time.perf_counter())
            choice = (json.loads(line[6:]).get("choices") or [{}])[0]
            content = (choice.get("message") or {}).get("content") or ""
            finishes.append(choice.get("finish_reason") or "")
            texts.append(content)
            if first is None and (content or finishes[-1] == "[DONE]"):
                first = stamps[-1] - t0
    text = "".join(texts)
    gaps = [b - a for a, b in zip([t0] + stamps, stamps)]
    return {"text": text, "replica": replica, "ttft": first, "frames": len(stamps),
            "max_gap": max(gaps) if gaps else 0.0, "finishes": finishes,
            "total_s": (stamps[-1] if stamps else time.perf_counter()) - t0,
            # (arrival, characters) of each frame
            "arrivals": [(t, len(c)) for t, c in zip(stamps, texts)],
            "history": messages + [{"role": "assistant", "content": text or "ok"}]}


def _metric_total(text: str, name: str, match: str = "") -> float:
    """The sum of a family's samples whose line holds ``match``."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name) and line[len(name):len(name) + 1] in ("{", " ") \
                and match in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


def _scrape(base, name, match="") -> float:
    status, text = _http(base, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"{base}/metrics: {status}")
    return _metric_total(text, name, match)


def _gpu_apps() -> dict:
    """pid -> MiB of the processes holding the card (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=30)
    apps = {}
    for line in out.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = float(parts[1]) if parts[1].replace(".", "").isdigit() else None
    return apps


def _wait_up(base, proc, log_path, what, timeout=600.0) -> float:
    t0 = time.time()
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited with {proc.returncode}: "
                                 f"{open(log_path, errors='replace').read()[-3000:]}")
        try:
            if _http(base, "GET", "/health", timeout=5)[0] == 200:
                return time.time() - t0
        except OSError:
            pass
        if time.time() - t0 > timeout:
            raise AssertionError(f"{what} did not answer /health in {timeout:.0f} s")
        time.sleep(0.5)


def _full_streams(rng, router, owner, tag, count) -> tuple:
    """``count`` messages keyed to ``owner`` whose streams run all their
    ``ROUTE_STREAM_TOKENS`` tokens (a random model can stop early): twice
    as many candidates run together and those that end within a tenth of
    the longest one's wall are kept (rows decode in lockstep), up to 4
    rounds; then the kept ones run together as the disturbed ones will,
    their undisturbed streams."""
    picked = []
    for attempt in range(4):
        cand = _owned_by(rng, owner, 120, f"{tag} {attempt}", 2 * count)
        runs = _concurrently({str(i): (lambda i=i: _route_stream(
            router, cand[i], ROUTE_STREAM_TOKENS)) for i in range(len(cand))})
        walls = [runs[str(i)]["total_s"] for i in range(len(cand))]
        log(f"  {tag}: candidates' walls (s): {[round(w, 2) for w in walls]}")
        picked += [cand[i] for i in range(len(cand)) if walls[i] >= 0.9 * max(walls)
                   and runs[str(i)]["replica"] == owner]
        if len(picked) >= count:
            msgs = picked[:count]
            ref = _concurrently({str(i): (lambda i=i: _route_stream(
                router, msgs[i], ROUTE_STREAM_TOKENS)) for i in range(count)})
            return msgs, [ref[str(i)] for i in range(count)]
    raise AssertionError(f"{tag}: fewer than {count} full streams on {owner} in 4 rounds")


def _disturbed(router, replica, msgs, act) -> tuple:
    """Run ``msgs`` together through ``router``; once ``replica`` has
    decoded ``ROUTE_MID_TOKENS`` tokens a stream on average (its
    ``genai_engine_generated_tokens_total``) and no stream has ended, call
    ``act()``; the streams' results, ``act``'s, when it was called and
    the seconds it took."""
    name = "genai_engine_generated_tokens_total"
    base = _scrape(replica, name)
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.update(
        {i: _route_stream(router, msgs[i], ROUTE_STREAM_TOKENS)}), name=f"smoke-route-{i}",
        daemon=True) for i in range(len(msgs))]
    for th in threads:
        th.start()
    deadline = time.time() + 300
    while _scrape(replica, name) - base < ROUTE_MID_TOKENS * len(msgs):
        if results or time.time() > deadline:
            raise AssertionError(f"a stream ended, or {replica} decoded too little, before "
                                 f"{ROUTE_MID_TOKENS} tokens a stream")
        time.sleep(0.02)
    if results:
        raise AssertionError("a stream ended before the disturbance")
    t_act = time.perf_counter()
    got = act()
    act_s = time.perf_counter() - t_act
    for th in threads:
        th.join(600)
    if len(results) != len(msgs):
        raise AssertionError("a disturbed client stream failed")
    return [results[i] for i in range(len(msgs))], got, t_act, act_s


def _handover_stats(results, ref, t_act) -> dict:
    """What the clients of a disturbed run saw: the characters each had
    before the disturbance, the longest wait for the next frame after it,
    and the wall each stream gained over its undisturbed run."""
    before = [sum(n for t, n in r["arrivals"] if t < t_act) for r in results]
    waits = [min((t for t, _ in r["arrivals"] if t >= t_act), default=t_act) - t_act
             for r in results]
    added = [r["total_s"] - w["total_s"] for r, w in zip(results, ref)]
    return {"chars_before": before, "next_frame_s": round(max(waits), 3),
            "added_wall_s": [round(a, 3) for a in added],
            "max_gap_s": round(max(r["max_gap"] for r in results), 3)}


def _handover_line(st) -> str:
    return (f"characters the clients had before it {st['chars_before']}; the longest wait "
            f"for the next frame after it {st['next_frame_s']} s; wall added to each stream "
            f"{st['added_wall_s']} s; longest gap between two frames {st['max_gap_s']} s")


def _router_timelines(router, since) -> list:
    status, text = _http(router, "GET", f"/internal/requests?since={since}&limit=1000")
    if status != 200:
        raise AssertionError(f"router /internal/requests: {status} {text[:200]}")
    return json.loads(text)["timelines"]


def phase_route(dev, smi, seed=0) -> dict:
    """Two llama3-8b replicas behind the port's router, and its frontend
    (module docstring, phase 14)."""
    import signal

    from generativeaiexamples_tpu_torch.router.ring import HashRing

    t0 = time.time()
    free, _ = torch.cuda.mem_get_info(dev)
    if free / 1e9 < ROUTE_MIN_FREE_GB:
        raise AssertionError(f"phase route needs {ROUTE_MIN_FREE_GB:.0f} GB free on the card, "
                             f"has {free / 1e9:.1f}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_route_")
    rng = np.random.RandomState(seed + 14)
    out, procs = {"smi": smi, "free_gb_before": round(free / 1e9, 1)}, []
    base_env = {k: v for k, v in os.environ.items() if not k.startswith("APP_")}

    def spawn(name, args, env):
        log_path = os.path.join(tmp, f"{name}.log")
        proc = subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=os.getcwd(),
                                stdout=open(log_path, "wb"), stderr=subprocess.STDOUT)
        procs.append((name, proc, log_path))
        return proc, log_path

    try:
        # 0. the fleet: two replicas started together, then the router and the frontend
        from generativeaiexamples_tpu_torch.models import hf_loader, llama

        ckpt = os.path.join(tmp, "model")
        hf_loader.write_hf_checkpoint(dataclasses.replace(llama.PRESETS[MODEL], num_layers=CUT_LAYERS),
                                      ckpt, seed=seed, dtype=torch.bfloat16, device=dev)
        ports = [_free_port() for _ in range(4)]
        reps = [f"http://127.0.0.1:{p}" for p in ports[:2]]
        router, frontend = (f"http://127.0.0.1:{p}" for p in ports[2:])
        t_start = time.time()
        for i in range(2):
            env = dict(base_env, **ROUTE_REPLICA_ENV, APP_ENGINE_CHECKPOINTPATH=ckpt,
                       APP_ENGINE_SNAPSHOTSPOOLDIR=os.path.join(tmp, "spool"),
                       APP_VECTORSTORE_PERSISTDIR=os.path.join(tmp, f"store{i}"),
                       DOC_UPLOAD_DIR=os.path.join(tmp, f"uploads{i}"),
                       PROFILE_LOG_DIR=os.path.join(tmp, f"profiles{i}"),
                       APP_BLACKBOX_DIR=os.path.join(tmp, f"blackbox{i}"))
            spawn(f"r{i}", ["generativeaiexamples_tpu_torch.server", "--host", "127.0.0.1",
                            "--port", str(ports[i]), *ROUTE_REPLICA_ARGS], env)
        host_env = dict(base_env, CUDA_VISIBLE_DEVICES="", **ROUTE_ROUTER_ENV)
        spawn("router", ["generativeaiexamples_tpu_torch.router", "--host", "127.0.0.1", "--port",
                         str(ports[2]), "--replica", reps[0], "--replica", reps[1]], host_env)
        spawn("frontend", ["generativeaiexamples_tpu_torch.frontend", "--host", "127.0.0.1",
                           "--port", str(ports[3]), "--chain-server", router],
              dict(base_env, CUDA_VISIBLE_DEVICES=""))
        up = []
        for i in range(2):
            _wait_up(reps[i], procs[i][1], procs[i][2], f"replica r{i}")
            up.append(time.time() - t_start)
        for name, base in (("router", router), ("frontend", frontend)):
            _, proc, log_path = next(p for p in procs if p[0] == name)
            _wait_up(base, proc, log_path, name)

        def warm(i):  # the first /generate builds the replica's engine
            _route_stream(reps[i], "warm up", 4)
            return time.time() - t_start

        ready = _concurrently({f"warm-r{i}": (lambda i=i: warm(i)) for i in range(2)})
        out["replica_start_s"] = {f"r{i}": {"health_s": round(up[i], 1),
                                            "first_answer_s": round(ready[f"warm-r{i}"], 1)}
                                  for i in range(2)}
        free_up, _ = torch.cuda.mem_get_info(dev)
        out["fleet_gb"] = round((free - free_up) / 1e9, 2)
        apps = _gpu_apps()
        pids = {name: proc.pid for name, proc, _ in procs}
        out["replica_mib"] = {f"r{i}": apps.get(pids[f"r{i}"]) for i in range(2)}
        out["gpu_apps_mib"] = apps
        on_card = [name for name in ("router", "frontend") if pids[name] in apps]
        if on_card:
            raise AssertionError(f"host-only processes hold the card: {on_card}")
        if None in out["replica_mib"].values():  # another PID namespace: all of them
            log(f"  nvidia-smi's compute apps (MiB by its pid): {apps}")
        log(f"  fleet: replicas answered /health in {up[0]:.1f} / {up[1]:.1f} s and their first "
            f"/generate {ready['warm-r0']:.1f} / {ready['warm-r1']:.1f} s after the start; "
            f"nvidia-smi: r0 {out['replica_mib']['r0']} MiB, r1 {out['replica_mib']['r1']} MiB "
            f"(router, frontend: not on the card); the card's free memory fell by "
            f"{out['fleet_gb']} GB ({out['fleet_gb'] / 2:.2f} a replica) from "
            f"{out['free_gb_before']} GB")

        # (a) placement: affinity, then round robin, on new conversations each
        hits_name = "genai_engine_prefix_cache_hits_total"
        ring = HashRing(["r0", "r1"])

        def conversations(policy, tag, concurrency):
            # owners interleaved: at ROUTE_CONCURRENCY each worker's conversations
            # share an owner, and two are in flight on each replica at a time
            by_owner = [_owned_by(rng, f"r{i}", ROUTE_FIRST_CHARS, tag,
                                  ROUTE_CONVERSATIONS // 2) for i in range(2)]
            firsts = [m for pair in zip(*by_owner) for m in pair]
            status, text = _http(router, "POST", "/internal/policy", {"policy": policy})
            if status != 200:
                raise AssertionError(f"/internal/policy {policy}: {status} {text}")
            before = sum(_scrape(b, hits_name) for b in reps)

            def worker(w):
                runs = []
                for first in firsts[w::concurrency]:
                    history, seen, ttfts = (), [], []
                    for turn in range(ROUTE_TURNS):
                        msg = first if turn == 0 else f"and then, part {turn + 1}?"
                        r = _route_stream(router, msg, ROUTE_TURN_TOKENS, history)
                        seen.append(r["replica"])
                        ttfts.append(r["ttft"])
                        history = r["history"]
                    runs.append((first, seen, ttfts))
                return runs

            t1 = time.perf_counter()
            runs = [run for rs in _concurrently({f"conv{w}": (lambda w=w: worker(w))
                                                 for w in range(concurrency)}).values()
                    for run in rs]
            wall = time.perf_counter() - t1
            hits = sum(_scrape(b, hits_name) for b in reps) - before
            return runs, hits, wall

        aff, aff_hits, aff_wall = conversations("affinity", "affinity", ROUTE_CONCURRENCY)
        for first, seen, _ in aff:
            if set(seen) != {ring.owner(first)}:
                raise AssertionError(f"affinity: a conversation's turns went to {seen}, its "
                                     f"ring owner is {ring.owner(first)}")
        if {seen[0] for _, seen, _ in aff} != {"r0", "r1"}:
            raise AssertionError("affinity: one replica owns every conversation")
        # round robin one request at a time: its counter then moves by one a
        # request, so each conversation's turns alternate replicas, as a blind
        # placement's do. Four workers in lockstep place requests in a fixed
        # cycle, which kept each conversation on one replica (as many hits as
        # affinity's) in some runs and not in others
        rr, rr_hits, rr_wall = conversations("round_robin", "round-robin", 1)
        _http(router, "POST", "/internal/policy", {"policy": "affinity"})
        if not aff_hits > rr_hits:
            raise AssertionError(f"prefix hits: affinity {aff_hits} not above round robin "
                                 f"{rr_hits}")
        ttft = [t for _, _, ts in aff + rr for t in ts]
        out["placement"] = {"affinity_hits": aff_hits, "round_robin_hits": rr_hits,
                            "affinity_wall_s": round(aff_wall, 2),
                            "round_robin_wall_s": round(rr_wall, 2),
                            "round_robin_replicas": [seen for _, seen, _ in rr],
                            "ttft_mean_s": round(statistics.mean(ttft), 3)}
        log(f"  placement: {ROUTE_CONVERSATIONS} conversations x {ROUTE_TURNS} turns at "
            f"concurrency {ROUTE_CONCURRENCY} ({ROUTE_FIRST_CHARS}+ ids first): affinity keeps "
            f"each on its ring owner, prefix hits {aff_hits:.0f} ({aff_wall:.1f} s); round robin "
            f"{rr_hits:.0f} ({rr_wall:.1f} s, replicas by conversation "
            f"{out['placement']['round_robin_replicas']}); TTFT mean {statistics.mean(ttft):.3f} s")

        # TTFT through the router against sent straight to the replica it picks
        pairs = {"router": [], "direct": []}
        for i in range(ROUTE_TTFT_PAIRS):
            msgs = [_route_text(rng, 300, f"ttft {i}-{k}:") for k in range(2)]
            r = _route_stream(router, msgs[0], 8)
            d = _route_stream(reps[int(r["replica"][1:])], msgs[1], 8)
            pairs["router"].append(r["ttft"])
            pairs["direct"].append(d["ttft"])
        out["ttft_router_s"] = round(statistics.mean(pairs["router"]), 4)
        out["ttft_direct_s"] = round(statistics.mean(pairs["direct"]), 4)
        log(f"  TTFT over {ROUTE_TTFT_PAIRS} short requests in turns: through the router "
            f"{out['ttft_router_s']:.4f} s mean, straight to the replica "
            f"{out['ttft_direct_s']:.4f} s")

        # (b) broadcast ingest
        docs = _rag_corpus(np.random.RandomState(seed))
        files = _rag_files(docs)[:ROUTE_DOCS]
        t1 = time.perf_counter()
        for filename, data in files:
            raw, ctype = _multipart(filename, data)
            status, text = _http(router, "POST", "/documents", raw=raw, ctype=ctype)
            if status != 200 or json.loads(text).get("replicas") != {"r0": 200, "r1": 200}:
                raise AssertionError(f"POST /documents {filename} at the router: {status} {text}")
        ingest_s = time.perf_counter() - t1
        names = [f for f, _ in files]
        for base in reps:
            status, text = _http(base, "GET", "/documents")
            if status != 200 or not set(names) <= set(json.loads(text)["documents"]):
                raise AssertionError(f"{base} GET /documents: {status} {text[:300]}")
        for k in range(ROUTE_DOCS):
            status, text = _http(router, "POST", "/search", {"query": docs[k][0], "top_k": 4})
            chunks = json.loads(text)["chunks"] if status == 200 else None
            if not chunks or chunks[0]["filename"] != names[k]:
                raise AssertionError(f"/search at the router for a sentence of {names[k]}: "
                                     f"{status} {text[:300]}")
        out["ingest_s"] = round(ingest_s, 2)
        log(f"  broadcast ingest: {ROUTE_DOCS} documents through the router in {ingest_s:.2f} s "
            f"(encoders built on first use), listed by both replicas; /search at the router "
            f"finds each document's sentence in it first")

        # (c) drain handover: r0 drains under 4 streams, r1 restores them
        drain_msgs, ref = _full_streams(rng, router, "r0", "drain", ROUTE_DRAIN_STREAMS)
        failover_name = "genai_router_failovers_total"
        pre0 = _scrape(router, failover_name, 'reason="preempted"')
        cursor = json.loads(_http(router, "GET", "/internal/requests")[1])["cursor"]
        results, (status, text), t_drain, drain_s = _disturbed(
            router, reps[0], drain_msgs, lambda: _http(reps[0], "POST", "/internal/drain", {}))
        if status != 200:
            raise AssertionError(f"r0 /internal/drain: {status} {text}")
        summary = json.loads(text)
        for i in range(ROUTE_DRAIN_STREAMS):
            got, want = results[i], ref[i]
            if got["text"] != want["text"] or "PREEMPTED" in got["finishes"] \
                    or got["finishes"][-1:] != ["[DONE]"]:
                raise AssertionError(f"drain: stream {i} {got['text']!r} ({got['finishes'][-3:]}) "
                                     f"against undisturbed {want['text']!r}")
        preempted = _scrape(router, failover_name, 'reason="preempted"') - pre0
        acks = [e.get("ack", "") for tl in _router_timelines(router, cursor)
                for e in tl.get("timeline", []) if e.get("event") == "restore"]
        if preempted != ROUTE_DRAIN_STREAMS or \
                sum("mode=restore" in a for a in acks) != ROUTE_DRAIN_STREAMS:
            raise AssertionError(f"drain: {preempted} preempted failovers, restore acks {acks}")
        status, text = _http(reps[0], "POST", "/internal/drain", {"resume": True})
        if status != 200:
            raise AssertionError(f"r0 resume: {status} {text}")
        out["drain"] = _handover_stats(results, ref, t_drain)
        out["drain"].update(summary={k: summary.get(k) for k in ("preempted", "spooled",
                                                                  "replay_only", "completed")},
                            drain_s=round(drain_s, 3), failovers_preempted=preempted)
        log(f"  drain handover: r0 drained under {ROUTE_DRAIN_STREAMS} streams of "
            f"{ROUTE_STREAM_TOKENS} tokens ~{ROUTE_MID_TOKENS} tokens in, in {drain_s:.3f} s "
            f"({out['drain']['summary']}); r1 restored each in mode restore; every client "
            f"stream equals its undisturbed text with no PREEMPTED frame; "
            f"failovers{{preempted}} +{preempted:.0f}; {_handover_line(out['drain'])}; r0 "
            f"resumed")

        # (d) tenants: the second request of 'limited' within its second sheds
        gen_name, gen_match = "genai_http_requests_total", 'route="/generate"'
        tenant = {"X-GenAI-Tenant": "limited"}
        counts = [_scrape(b, gen_name, gen_match) for b in reps]
        held = {}
        holder = threading.Thread(target=lambda: held.update(first=_route_stream(
            router, "tenant probe", 4, headers=tenant)), name="smoke-tenant", daemon=True)
        holder.start()
        time.sleep(0.3)  # the first is admitted (its token spent) before the second arrives
        req = urllib.request.Request(router + "/generate", headers={
            "Content-Type": "application/json", **tenant}, data=json.dumps({
                "messages": [{"role": "user", "content": "tenant probe"}],
                "use_knowledge_base": False, "max_tokens": 4, **ROUTE_SAMPLING}).encode())
        shed_status, retry_after = 200, None
        try:
            urllib.request.urlopen(req, timeout=60).read()
        except urllib.error.HTTPError as exc:
            shed_status, retry_after = exc.code, exc.headers.get("Retry-After")
            exc.read()
        holder.join(600)
        moved = [_scrape(b, gen_name, gen_match) - c for b, c in zip(reps, counts)]
        if shed_status != 429 or not retry_after or "first" not in held or sum(moved) != 1:
            raise AssertionError(f"tenant: {shed_status}, Retry-After {retry_after!r}, the "
                                 f"replicas' /generate counts moved by {moved}")
        log(f"  tenant 'limited' (rate=1,burst=1): its second request within a second answers "
            f"429 with Retry-After {retry_after}; the replicas' /generate counts moved by "
            f"{moved}: the first request's only")

        # (e) the frontend: one chat through /api/generate equals the router's answer
        chat = _route_text(rng, 200, "frontend:")
        via_fe = _route_stream(frontend, chat, 32, path="/api/generate")
        direct = _route_stream(router, chat, 32)
        if via_fe["text"] != direct["text"] or via_fe["finishes"][-1:] != ["[DONE]"]:
            raise AssertionError(f"frontend: {via_fe['text']!r} against the router's "
                                 f"{direct['text']!r}")
        log(f"  frontend: /api/generate through the router equals the router's own answer "
            f"({len(direct['text'])} characters, on {direct['replica']})")

        # (f) the stitched trace of one request
        trace_id = f"{int(rng.randint(1, 1 << 31)):08x}" + "9f" * 12
        r = _route_stream(router, "trace probe " + trace_id, 8,
                          headers={"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
        status, text = _http(router, "GET", f"/internal/trace/{trace_id}")
        doc = json.loads(text) if status == 200 else {}
        events = collections.defaultdict(list)
        for e in doc.get("timeline", []):
            events[e["source"]].append(e["event"])
        if not {"placement", "first_byte", "proxied"} <= set(events["router"]) \
                or "first_token" not in events[r["replica"]]:
            raise AssertionError(f"/internal/trace/{trace_id}: {status} {dict(events)}")
        log(f"  stitched trace: router hop {events['router']}, {r['replica']}'s phases "
            f"{events[r['replica']]}")

        # (g) the kernels ran on the card inside the replica: a profile of r0
        for attempt in range(1, OBSERVE_PROFILE_TRIES + 1):
            pair = _owned_by(rng, "r0", 200, f"profile {attempt}", 2)
            status, text = _http(reps[0], "POST", "/internal/profile/start", raw=b"")
            if status != 200:
                raise AssertionError(f"r0 /internal/profile/start: {status} {text}")
            _concurrently({str(i): (lambda i=i: _route_stream(router, pair[i], 8))
                           for i in range(2)})
            status, text = _http(reps[0], "POST", "/internal/profile/stop", raw=b"")
            if status != 200:
                raise AssertionError(f"r0 /internal/profile/stop: {status} {text}")
            prof = json.loads(text)
            seen = {n for n, _, _ in device_trace.chrome_trace_events(prof["trace"])}
            found = {k: any(re.search(k, n) for n in seen) for k in OBSERVE_KERNELS}
            log(f"  r0 profile {attempt}: complete {prof['complete']}; by kernel "
                f"{prof['kernels_in_trace']} in the trace of {prof['kernels_launched']} launched "
                f"by the replica's wrappers; kernels {found}")
            launched = prof["kernels_launched"]
            if prof["complete"] and all(found.values()) and all(
                    launched.get(k, 0) > 0 for k in ROUTE_LAUNCHED):
                break
        else:
            raise AssertionError(f"no complete r0 profile holding {OBSERVE_KERNELS} with "
                                 f"{ROUTE_LAUNCHED} launched by the replica's wrappers")
        out["profile"] = {k: prof[k] for k in ("complete", "kernels_in_trace", "kernels_launched",
                                               "busy_ms", "wall_ms", "idle_share")}

        # (h) replay on death: r1 killed under 2 streams, r0 replays them
        kill_msgs, ref = _full_streams(rng, router, "r1", "kill", ROUTE_KILL_STREAMS)
        died0 = _scrape(router, failover_name, 'reason="replica_died"')
        r1_proc = procs[1][1]
        results, _, t_kill, _ = _disturbed(router, reps[1], kill_msgs, lambda: (
            r1_proc.send_signal(signal.SIGKILL), r1_proc.wait(60)))
        for i in range(ROUTE_KILL_STREAMS):
            if results[i]["text"] != ref[i]["text"] or \
                    results[i]["finishes"][-1:] != ["[DONE]"]:
                raise AssertionError(f"kill: stream {i} {results[i]['text']!r} against "
                                     f"undisturbed {ref[i]['text']!r}")
        died = _scrape(router, failover_name, 'reason="replica_died"') - died0
        deadline = time.time() + 30
        while True:
            fleet = json.loads(_http(router, "GET", "/internal/fleet")[1])
            if fleet["replicas"]["r1"]["state"] == "unhealthy" or time.time() > deadline:
                break
            time.sleep(0.5)
        after = _route_stream(router, "after the death", 4)
        if died < 1 or fleet["replicas"]["r1"]["state"] != "unhealthy" \
                or fleet["placeable"] != ["r0"] or after["replica"] != "r0":
            raise AssertionError(f"kill: failovers{{replica_died}} +{died}, fleet {fleet}, then "
                                 f"{after['replica']}")
        out["kill"] = _handover_stats(results, ref, t_kill)
        out["kill"]["failovers_replica_died"] = died
        log(f"  replay on death: r1 SIGKILLed under {ROUTE_KILL_STREAMS} streams "
            f"~{ROUTE_MID_TOKENS} tokens in; both client streams equal their undisturbed text; "
            f"failovers{{replica_died}} +{died:.0f}; {_handover_line(out['kill'])}; "
            f"/internal/fleet marks r1 unhealthy; /generate answers 200 on r0")

        # the router's own SLO objectives and families
        status, text = _http(router, "GET", "/internal/slo")
        objectives = json.loads(text)["objectives"]
        if set(objectives) != {"proxy_overhead_p95", "failover_rate"}:
            raise AssertionError(f"router /internal/slo: {objectives}")
        families = set(re.findall(r"^# TYPE (genai_router_\w+)", _http(router, "GET",
                                                                        "/metrics")[1], re.M))
        if len(families) != 8:
            raise AssertionError(f"router /metrics: {sorted(families)}")
        p95 = objectives["proxy_overhead_p95"]
        out["proxy_overhead_p95_ms"] = p95["p95_ms"]
        out["failover_rate"] = objectives["failover_rate"]["rate"]
        log(f"  router: proxy overhead p95 {p95['p95_ms']} ms over {p95['samples']} requests "
            f"against slo.router_proxy_overhead_p95_ms {p95['target_ms']} (met {p95['met']}); "
            f"failover rate {out['failover_rate']}; /metrics lists the 8 genai_router_* families")
    finally:
        for name, proc, _ in procs:
            if proc.poll() is None:
                proc.terminate()
        for name, proc, log_path in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.time() - t0
    log(f"phase route: ok ({out['wall_s']:.1f} s against a budget of {ROUTE_BUDGET_S:.0f} s "
        f"on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 15: the config file, the native store and the framework connectors

CONNECT_BUDGET_S = 120.0
CONNECT_QUERIES = 32
CONNECT_K = 4
CONNECT_TOKENS = 24  # each connector call, greedy
CONNECT_UPLOADS = 2  # phase 7's documents uploaded to the chain server
CONNECT_SEARCH_TOL = 1e-5  # f32 dot products of 1024-dim unit vectors, other sum orders
CONNECT_PROFILE_TRIES = 3  # CUPTI can drop a session's events: capture again
CONNECT_CHILD_S = 600  # the time limit of the phase's process
# the JAX package's messages when a client package is missing
CONNECT_MISSING = {
    "milvus": ("pymilvus",
               "pymilvus is not installed; use vector_store.name=tpu or install pymilvus"),
    "pgvector": ("psycopg2",
                 "psycopg2 is not installed; use vector_store.name=tpu or install psycopg2"),
}
CONNECT_KERNELS = ("int8_matmul_mma", "paged_split_kernel", "flash_attention_kernel")


def _connect_file(store_dir, ckpt) -> dict:
    """Phase 7's deployment as a camelCase configuration file: engine A
    from the checkpoint ``ckpt``, arctic-embed-l on the card, the ``faiss``
    store under ``store_dir``, the hybrid pipeline (dense + BM25, no
    reranker: the native store's hits reach /search) at ``topK`` 2."""
    return {
        "engine": {"modelConfigName": MODEL, "quantization": "int8",
                   "kvCacheDtype": "bfloat16", "kvLayout": "paged", "tensorParallelism": 1,
                   "checkpointPath": ckpt},
        "llm": {"modelEngine": "tpu"},
        "embeddings": {"modelEngine": "tpu"},
        "ranking": {"modelEngine": ""},
        "retriever": {"topK": 2, "nrPipeline": "hybrid", "scoreThreshold": 0.0},
        "textSplitter": {"chunkSize": 48, "chunkOverlap": 16},
        "vectorStore": {"name": "faiss", "persistDir": store_dir},
    }


def _write_json(path, doc) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return path


def _connect_config(tmp, ckpt) -> tuple:
    """(a): the file, the environment on top, and a refused value from a
    file against the same value from the environment."""
    from generativeaiexamples_tpu_torch import config as config_mod

    path = _write_json(os.path.join(tmp, "app.json"),
                       _connect_file(os.path.join(tmp, "store"), ckpt))
    os.environ["APP_CONFIG_FILE"] = path
    os.environ["APP_RETRIEVER_TOPK"] = "3"
    config_mod.get_config.cache_clear()
    cfg = config_mod.get_config()
    got = (cfg.engine.model_config_name, cfg.engine.quantization, cfg.engine.kv_cache_dtype,
           cfg.engine.kv_layout, cfg.engine.checkpoint_path, cfg.vector_store.name,
           cfg.vector_store.persist_dir, cfg.retriever.top_k, cfg.retriever.nr_pipeline,
           cfg.embeddings.model_engine, cfg.text_splitter.chunk_size)
    want = (MODEL, "int8", "bfloat16", "paged", ckpt, "faiss", os.path.join(tmp, "store"), 3,
            "hybrid", "tpu", 48)
    if got != want:
        raise AssertionError(f"connect (a): get_config() gave {got}, not {want}")
    bad = _write_json(os.path.join(tmp, "chunked.json"), {"engine": {"chunkedPrefill": "off"}})
    messages = []
    for source in ("file", "env"):
        try:
            if source == "file":
                config_mod.AppConfig.from_file(bad)
            else:
                config_mod.AppConfig.from_env({"APP_ENGINE_CHUNKEDPREFILL": "off"})
        except ValueError as exc:
            messages.append(str(exc))
        else:
            raise AssertionError(f"connect (a): chunkedPrefill off from the {source} was accepted")
    if messages[0] != messages[1]:
        raise AssertionError(f"connect (a): the file's refusal {messages[0]!r} is not the "
                             f"environment's {messages[1]!r}")
    pp2 = _write_json(os.path.join(tmp, "pp2.json"), {"engine": {"pipelineParallelism": 2}})
    if config_mod.AppConfig.from_file(pp2).engine.pipeline_parallelism != 2:
        raise AssertionError("connect (a): pipelineParallelism 2 from a file was not read")
    log(f"  (a) get_config() from APP_CONFIG_FILE with APP_RETRIEVER_TOPK=3 on top: {want}; "
        f"engine.chunkedPrefill off from a file and from the environment both refused with "
        f"{messages[0]!r}; engine.pipelineParallelism 2 from a file read as 2")
    return cfg, path


def _topk_matches(got, want, k, tol) -> float:
    """``got``'s k hits against the exact ``want`` (k + a few): scores
    within ``tol`` rank by rank and every id among those whose exact score
    reaches the k-th's less ``tol`` (equal scores count as a set). The
    largest score difference."""
    worst = 0.0
    floor = want[k - 1].score - tol
    allowed = {h.chunk.text for h in want if h.score >= floor}
    if len(got) != k:
        raise AssertionError(f"{len(got)} hits, not {k}")
    for g, w in zip(got, want):
        worst = max(worst, abs(g.score - w.score))
        if abs(g.score - w.score) > tol or g.chunk.text not in allowed:
            raise AssertionError(f"hit {g.chunk.text[:40]!r} ({g.score:.7f}) against "
                                 f"{w.chunk.text[:40]!r} ({w.score:.7f})")
    return worst


def _connect_stores(cfg, emb, docs, tmp, smi) -> dict:
    """(b): the same vectors in faiss (flat), ivf and the in-process store
    on the card; 32 queries; persistence; the two client stores refused."""
    from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
    from generativeaiexamples_tpu_torch.retrieval.native_store import NativeVectorStore
    from generativeaiexamples_tpu_torch.retrieval.store import Chunk, create_vector_store
    from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

    passages = [s for doc in docs for s in doc]
    chunks = [Chunk(text=p, source=f"doc{d:02d}") for d, doc in enumerate(docs) for p in doc]
    vecs = np.asarray(emb.embed_documents(passages), np.float32)
    rng = np.random.RandomState(15)
    queries = [passages[i] for i in rng.choice(len(passages), CONNECT_QUERIES, replace=False)]
    qvecs = [np.asarray(emb.embed_query(q), np.float32) for q in queries]
    dims = vecs.shape[1]
    stores, out = {}, {"passages": len(passages), "dims": dims}
    for kind in ("faiss", "ivf", "tpu"):
        stores[kind] = create_vector_store(kind, dims, persist_dir=os.path.join(tmp, "b", kind),
                                           collection="b", ann_mode="exact")
        stores[kind].add(chunks, vecs)
    if type(stores["faiss"]) is not NativeVectorStore or type(stores["ivf"]) is not \
            NativeVectorStore or type(stores["tpu"]) is not TorchVectorStore:
        raise AssertionError(f"connect (b): the factory served "
                             f"{ {k: type(v).__name__ for k, v in stores.items()} }")
    hits, ms = {}, {}
    for kind, store in stores.items():
        store.search(qvecs[0], CONNECT_K)  # warm
        t = time.perf_counter()
        hits[kind] = [store.search(q, CONNECT_K + 4 if kind == "tpu" else CONNECT_K)
                      for q in qvecs]
        ms[kind] = (time.perf_counter() - t) * 1e3 / len(qvecs)
    worst = max(_topk_matches(f, e, CONNECT_K, CONNECT_SEARCH_TOL)
                for f, e in zip(hits["faiss"], hits["tpu"]))
    recall = statistics.mean(
        len({h.chunk.text for h in i} & {h.chunk.text for h in e[:CONNECT_K]}) / CONNECT_K
        for i, e in zip(hits["ivf"], hits["tpu"]))
    reopened = create_vector_store("faiss", dims, persist_dir=os.path.join(tmp, "b", "faiss"),
                                   collection="b")
    if reopened is stores["faiss"] or reopened.count() != len(passages):
        raise AssertionError("connect (b): the reopened faiss store is not a fresh full one")
    again = [reopened.search(q, CONNECT_K) for q in qvecs]
    if [[(h.chunk.text, h.score) for h in r] for r in again] != \
            [[(h.chunk.text, h.score) for h in r] for r in hits["faiss"]]:
        raise AssertionError("connect (b): the reopened faiss store answers otherwise")
    for name, (module, message) in CONNECT_MISSING.items():
        saved = sys.modules.get(module, "absent")
        sys.modules[module] = None  # the import fails even where the package exists
        try:
            create_vector_store(name, dims, url="http://127.0.0.1:1", collection="b")
        except VectorStoreError as exc:
            if str(exc) != message:
                raise AssertionError(f"connect (b): {name}: {exc}") from exc
        else:
            raise AssertionError(f"connect (b): {name} without {module} built a store")
        finally:
            if saved == "absent":
                sys.modules.pop(module, None)
            else:
                sys.modules[module] = saved
    out.update(search_ms=ms, ivf_recall_at_4=recall, flat_max_score_diff=worst)
    log(f"  (b) {len(passages)} sentences of phase 7's documents embedded on the card "
        f"({dims} dims) into faiss ({type(stores['faiss']).__name__}, flat), ivf (nlist 64, "
        f"nprobe 8) and tpu ({type(stores['tpu']).__name__}, on the card): for "
        f"{CONNECT_QUERIES} queries flat gives the exact store's top {CONNECT_K} (scores within "
        f"{worst:.3g}, limit {CONNECT_SEARCH_TOL}); IVF recall@{CONNECT_K} {recall:.3f}; "
        f"search a query flat {ms['faiss']:.4f} ms, ivf {ms['ivf']:.4f} ms, tpu "
        f"{ms['tpu']:.4f} ms (host wall) on {smi}; persisted and reopened: the same hits; "
        f"milvus and pgvector without their client packages raise JAX's VectorStoreError")
    return out


def _connect_calls(engine, backend, query, retriever_query) -> dict:
    """(c)'s in-process calls, in the order they are compared."""
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.integrations.langchain import ChatTPU, TPUEmbeddings
    from generativeaiexamples_tpu_torch.integrations.llamaindex import (
        TPULlamaIndexLLM, TPULlamaIndexRetriever,
    )
    from generativeaiexamples_tpu_torch.integrations.pandasai import TPULLM

    greedy = dict(temperature=0.0, top_p=1.0, max_tokens=CONNECT_TOKENS)
    msgs = [("system", "You are a terse assistant."), ("user", query)]
    chat = ChatTPU(**greedy)
    if chat._backend._engine is not engine:
        raise AssertionError("connect (c): ChatTPU() did not take the process engine")
    out = {
        "backend_pieces": list(backend.stream_chat(msgs, **greedy)),
        "invoke": chat.invoke(msgs),
        "stream": list(chat.stream(msgs)),
        "backend_complete": backend.complete([("user", query)], **greedy),
        "complete": TPULlamaIndexLLM(**greedy).complete(query).text,
        "stream_complete": "".join(r.delta for r in
                                   TPULlamaIndexLLM(**greedy).stream_complete(query)),
        "pandasai": TPULLM(**greedy).call(query),
    }
    texts = [f"{query} {i}" for i in range(3)]
    emb, mine = TPUEmbeddings(), runtime.get_embedder()
    out["embed_diff"] = max(
        float(np.abs(np.asarray(emb.embed_documents(texts)) - mine.embed_documents(texts)).max()),
        float(np.abs(np.asarray(emb.embed_query(query)) - mine.embed_query(query)).max()))
    nodes = TPULlamaIndexRetriever().retrieve(retriever_query)
    hits = runtime.retrieve(retriever_query)
    out["retriever"] = ([(n.node.text, n.node.metadata["filename"], n.score) for n in nodes],
                        [(h.chunk.text, h.chunk.source, h.score) for h in hits])
    return out


def _check_connect_calls(out, remote_text) -> None:
    want = "".join(out["backend_pieces"])  # the system and user messages
    if out["invoke"] != want:
        raise AssertionError(f"connect (c): invoke gave {out['invoke']!r}, the backend {want!r}")
    if out["stream"] != out["backend_pieces"]:
        raise AssertionError(f"connect (c): ChatTPU.stream pieces {out['stream']!r} against the "
                             f"backend's {out['backend_pieces']!r}")
    for key in ("complete", "stream_complete", "pandasai"):  # one user message
        if out[key] != out["backend_complete"]:
            raise AssertionError(f"connect (c): {key} gave {out[key]!r}, the backend "
                                 f"{out['backend_complete']!r}")
    if remote_text != want:
        raise AssertionError(f"connect (c): ChatTPU over the engine server gave "
                             f"{remote_text!r}, in process {want!r}")
    if out["embed_diff"] != 0.0:
        raise AssertionError(f"connect (c): TPUEmbeddings differ from the runtime's embedder "
                             f"by {out['embed_diff']}")
    nodes, hits = out["retriever"]
    if not hits or nodes != hits:
        raise AssertionError(f"connect (c): the retriever's nodes {nodes} against "
                             f"runtime.retrieve's {hits}")


def phase_connect(dev, smi, seed=0) -> dict:
    """The configuration file, the native store and the framework
    connectors at full llama3-8b, recipe A (module docstring, phase 15)."""
    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.integrations.langchain import ChatTPU
    from generativeaiexamples_tpu_torch.retrieval import native_index
    from generativeaiexamples_tpu_torch.retrieval.native_store import NativeVectorStore
    from generativeaiexamples_tpu_torch.utils import tracing

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_connect_")
    keys = [k for k in os.environ if k.startswith("APP_")] + ["APP_CONFIG_FILE",
                                                                "APP_RETRIEVER_TOPK"]
    saved_env = {k: os.environ.get(k) for k in keys}
    for key in keys:  # the file and this phase's own variables configure it, nothing earlier
        if key != "APP_BLACKBOX_DIR":
            os.environ.pop(key, None)
    out, proc, http_server = {"smi": smi}, None, None
    docs = _rag_corpus(np.random.RandomState(seed))
    try:
        # engine A from a bf16 checkpoint of CUT_LAYERS layers (since phase
        # 21; random int8 packs at full depth before): (d)'s server process
        # loads it in seconds where it drew the full model's packs for ~50
        from generativeaiexamples_tpu_torch.models import hf_loader, llama

        ckpt = os.path.join(tmp, "model")
        hf_loader.write_hf_checkpoint(llama.PRESETS[_cut_model(CUT_LAYERS)], ckpt, seed=seed,
                                      dtype=torch.bfloat16, device=dev)
        cfg, _ = _connect_config(tmp, ckpt)

        # (d)'s chain server starts now, from a file of its own (its own
        # store), and comes up while the in-process deployment builds
        server_file = _write_json(os.path.join(tmp, "server.json"),
                                  _connect_file(os.path.join(tmp, "server_store"), ckpt))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("APP_") or k == "APP_BLACKBOX_DIR"}
        env.update(APP_CONFIG_FILE=server_file, EXAMPLE_NAME="developer_rag",
                   DOC_UPLOAD_DIR=os.path.join(tmp, "uploads"))
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        log_path = os.path.join(tmp, "server.log")
        t_spawn = time.time()
        proc = subprocess.Popen([sys.executable, "-m", "generativeaiexamples_tpu_torch.server",
                                 "--host", "127.0.0.1", "--port", str(port)], env=env,
                                cwd=os.getcwd(), stdout=open(log_path, "wb"),
                                stderr=subprocess.STDOUT)

        t_build = time.time()
        if not native_index.available():
            raise AssertionError(f"connect: the native index did not build: "
                                 f"{native_index.unavailable_reason()}")
        out["native_build_s"] = time.time() - t_build
        runtime.reset_runtime()
        runtime.set_device(None)
        cfg = config_mod.get_config()
        t_dep = time.time()
        emb = runtime.get_embedder(cfg)
        backend = runtime.get_llm(cfg)
        engine = backend._engine
        if not isinstance(emb, TorchEmbedder) or engine is not llm_engine._ENGINE or \
                engine.device.type != "cuda" or not engine._paged:
            raise AssertionError("connect: the factories did not build the encoder and engine A "
                                 "on the card")
        store = runtime.get_vector_store("default", cfg)
        if type(store) is not NativeVectorStore:
            raise AssertionError(f"connect: vector store 'faiss' is served by "
                                 f"{type(store).__name__}, not NativeVectorStore")
        out["deploy_s"] = time.time() - t_dep
        log(f"  native index built with g++ in {out['native_build_s']:.2f} s; the store serving "
            f"'faiss' is {type(store).__name__}; engine A and arctic-embed-l built in "
            f"{out['deploy_s']:.1f} s")

        out["stores"] = _connect_stores(cfg, emb, docs, tmp, smi)

        # two of phase 7's documents in the runtime's faiss collection
        files = _rag_files(docs)[:CONNECT_UPLOADS]
        for name, data in files:
            path = os.path.join(tmp, name)
            with open(path, "wb") as fh:
                fh.write(data)
            runtime.ingest_file(path, name)
        query = " ".join(docs[0][1].split()[:8])
        search_query = docs[1][2]

        # (c) the connectors, traced, against the engine server on the same engine
        from generativeaiexamples_tpu_torch.engine.server import make_server

        http_server = make_server("127.0.0.1", 0, engine=engine)
        threading.Thread(target=http_server.serve_forever, name="smoke-connect-http",
                         daemon=True).start()
        remote = f"http://127.0.0.1:{http_server.server_address[1]}/v1"
        exporter = tracing.InMemorySpanExporter()
        tracing.set_tracer(tracing.Tracer(exporter=exporter, flush_interval=0.1))
        launches, captures = collections.Counter(), []
        try:
            for attempt in range(CONNECT_PROFILE_TRIES):
                _settle(engine)
                reset_counts()
                with device_trace.DeviceWindow() as win:
                    calls = _connect_calls(engine, backend, query, search_query)
                launches.update(counts())
                prof = win.result
                captures.append({k: prof[k] for k in ("kernels_in_trace", "kernels_launched",
                                                      "device_events")})
                if prof["complete"]:
                    break
                log(f"    profile attempt {attempt + 1}: incomplete ({prof['kernels_in_trace']} "
                    f"in the trace of {prof['kernels_launched']} launched); again")
            greedy = dict(temperature=0.0, top_p=1.0, max_tokens=CONNECT_TOKENS)
            remote_text = ChatTPU(base_url=remote, model="llama3-8b", **greedy).invoke(
                [("system", "You are a terse assistant."), ("user", query)])
            tracing.get_tracer().force_flush()
            spans = [s for s in exporter.spans if s.name == "llm.chat"]
        finally:
            tracing.reset_tracer()
        _check_connect_calls(calls, remote_text)
        missing = [k for k in RAG_EXPECTED if not launches.get(k)]
        if missing:
            raise AssertionError(f"connect (c): kernels not launched: {missing} ({dict(launches)})")
        span = spans[0] if spans else None
        if span is None or set(span.attributes) - {"service.name"} != {
                "llm.temperature", "llm.top_p", "llm.max_tokens", "llm.messages", "llm.chunks",
                "llm.completion_chars"} or not all(
                e["name"] == "llm.new_token" for e in span.events):
            raise AssertionError(f"connect (c): the llm.chat span: {span}")
        out["launches"] = dict(launches)
        out["texts"] = {"chars": len(calls["invoke"]), "pieces": len(calls["stream"])}
        log(f"  (c) in process: ChatTPU.invoke, .stream ({len(calls['stream'])} pieces in "
            f"order), TPULlamaIndexLLM.complete/.stream_complete and pandasai TPULLM.call equal "
            f"the backend's greedy text ({len(calls['invoke'])} characters, "
            f"{CONNECT_TOKENS} tokens); ChatTPU(base_url=...) over the engine server the same; "
            f"TPUEmbeddings equal the runtime embedder's vectors; TPULlamaIndexRetriever over "
            f"the faiss collection equals runtime.retrieve ({len(calls['retriever'][1])} hits); "
            f"{len(spans)} llm.chat spans, one: attributes "
            f"{ {k: v for k, v in span.attributes.items() if k != 'service.name'} }, "
            f"{len(span.events)} llm.new_token events; launches {dict(launches)}")
        if not prof["complete"]:
            raise AssertionError(f"connect (e): no complete profile in {CONNECT_PROFILE_TRIES} "
                                 f"captures: {captures}")
        held = [k for k in CONNECT_KERNELS if prof["kernels_in_trace"].get(k)]
        if len(held) != len(CONNECT_KERNELS):
            raise AssertionError(f"connect (e): the profile holds {prof['kernels_in_trace']}")
        out["profile"] = {k: prof[k] for k in ("busy_ms", "wall_ms", "idle_share",
                                               "kernels_in_trace", "kernels_ms")}
        log(f"  (e) profile of (c)'s in-process calls: complete kernel by kernel "
            f"{prof['kernels_in_trace']}; busy {prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
            f"wall (idle share {prof['idle_share']:.3f}) on {smi}")

        # (d) the chain server from the file alone
        _wait_up(base, proc, log_path, "the chain server")
        t_up = time.time() - t_spawn
        for name, data in files:
            raw, ctype = _multipart(name, data)
            status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
            if status != 200:
                raise AssertionError(f"connect (d): POST /documents {name}: {status} {text}")
        status, text = _http(base, "POST", "/search", {"query": search_query, "top_k": 4})
        local = [{"content": h.chunk.text, "filename": h.chunk.source, "score": h.score}
                 for h in runtime.retrieve(search_query, top_k=4)]
        if status != 200 or not local or not _same_search(
                (status, text), (200, json.dumps({"chunks": local}))):
            raise AssertionError(f"connect (d): /search {status} {text} against the in-process "
                                 f"{local}")
        frames, ttft, total = _generate_stream(base, query, kb=True, max_tokens=16)
        if (frames[-1].get("choices") or [{}])[0].get("finish_reason") != "[DONE]":
            raise AssertionError(f"connect (d): /generate ended with {frames[-1]}")
        out["server"] = {"up_since_spawn_s": round(t_up, 1),
                         "generate_ttft_s": ttft, "generate_s": total}
        log(f"  (d) python -m generativeaiexamples_tpu_torch.server with only APP_CONFIG_FILE "
            f"(EXAMPLE_NAME=developer_rag): /health {t_up:.1f} s after its start; "
            f"{CONNECT_UPLOADS} documents uploaded; /search equals the in-process hits "
            f"({len(local)}); /generate streamed {len(frames)} frames to [DONE] (first answer "
            f"frame {ttft:.2f} s, {total:.2f} s)")
    finally:
        if http_server is not None:
            http_server.shutdown()
            http_server.server_close()
        if proc is not None:
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        eng = llm_engine._ENGINE
        if eng is not None:
            eng.shutdown()
        with llm_engine._ENGINE_LOCK:
            llm_engine._ENGINE = None
        runtime.reset_runtime()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        config_mod.get_config.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.time() - t0
    log(f"phase connect: ok ({out['wall_s']:.1f} s against a budget of {CONNECT_BUDGET_S:.0f} s "
        f"on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 16: tensor-parallel serving

TP_SHARDS_8B = 2
TP_SHARDS_70B = 8
TP_MODEL_70B = "llama3-70b"
TP_LAYERS_70B = 4  # of its 80
TP_LAYERS_BC = 4  # recipes B and C at 8b: 4 of 32 layers
# prompt lengths (ids): those up to prefill_chunk (512) prefill as one
# monolithic wave through flash, the rest chunk by chunk
TP_LENGTHS_8B = (100, 230, 380, 500, 640, 800, 990, 1200)
TP_LENGTHS_70B = (150, 480, 760, 1150)
TP_TOKENS = 32
TP_MAX_SEQ = 2048  # prompts of 100-1,200 ids and 32 tokens
TP_SERVER_REQUESTS = 3
TP_BUDGET_S = 120.0
# the largest |logits difference| a leg's prefills may show between TP=N
# and TP=1 on the same weights: the row reduce rounds each shard's bf16
# partial (and under W8A8 each row shard scales its own K slice), about
# twice the readings of NVIDIA H100 80GB HBM3 at 700 W, and below
# LOGITS_TOL, so a reduce or copy fault the tie rule would let through
# fails here
TP_LOGITS_LIMITS = {"8b A": 0.2, "8b B": 0.45, "8b C": 0.2, "8b D": 0.2, "70b A": 0.1}


def _tp_prompts(rng, lengths) -> list:
    """Prompts of random byte ids at ``lengths``."""
    return [[256] + [rng.randrange(1, 256) for _ in range(n - 1)] for n in lengths]


def _tp_streams(engine, prompts, tokens=TP_TOKENS) -> tuple:
    """Greedy streams of ``prompts`` admitted as one wave; (streams, the
    wall of a decode block in ms: the reader's decode time a block)."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    params = SamplingParams(temperature=0.0, max_tokens=tokens)
    before = engine.stats()
    with engine.hold_admissions():
        queues = [engine.generate_ids(p, params) for p in prompts]
    streams = [_drain_ids(q) for q in queues]
    after = engine.stats()
    blocks = after["decode_blocks"] - before["decode_blocks"]
    wall = 1e3 * (after["decode_time_s"] - before["decode_time_s"]) / max(blocks, 1)
    return streams, wall


def _tp_logits_diff(ref, engine, prompts) -> float:
    """Largest |logits difference| of the prefills of ``prompts`` (each
    whole, as one wave of one row) at TP=1 and TP=N on the same weights
    (the model functions, no engine state)."""
    from generativeaiexamples_tpu_torch.models import llama

    diff = 0.0
    for prompt in prompts:
        ids = torch.tensor([prompt], device=ref.device)
        n = torch.tensor([ids.shape[1]], device=ref.device)
        with torch.inference_mode():
            a, _ = llama.prefill_layers(ref.params, ref.model_config, ids, n,
                                        quant_kernel=ref._quant_kernel)
            b, _ = llama.prefill_layers(engine.params, engine.model_config, ids, n,
                                        quant_kernel=engine._quant_kernel, tp=engine._tp)
        diff = max(diff, _max_err(a, b))
    return diff


def tp_leg(dev, label, model, quantization, kv_dtype, layout, params, shards, prompts,
           expected) -> dict:
    """One leg: a TP=1 engine and a TP=``shards`` engine (all shards on
    ``dev``) on the same single-device tree; the TP engine's streams equal
    the TP=1 engine's or part at a random-init tie, and its path launched
    each kernel. Returns its numbers, the TP engine's launches and the TP
    engine itself (shut down)."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.parallel import create_mesh

    base = EngineConfig(model_config_name=model, quantization=quantization, kv_cache_dtype=kv_dtype,
                        kv_layout=layout, max_seq_len=TP_MAX_SEQ, tensor_parallelism=1)
    t0 = time.time()
    held = torch.cuda.memory_allocated(dev)  # the single-device tree and what earlier phases hold
    torch.cuda.reset_peak_memory_stats(dev)
    ref = LLMEngine(base, device=dev, params=params)
    try:
        want, wall_1 = _tp_streams(ref, prompts)
    finally:
        ref.shutdown()
    engine = LLMEngine(dataclasses.replace(base, tensor_parallelism=shards), params=params,
                       mesh=create_mesh(shards, devices=[dev] * shards))
    try:
        if engine.tp_shards != shards or engine._paged != (layout == "paged"):
            raise AssertionError(f"tp {label}: the engine is not the one asked for")
        reset_counts()
        with SyncCounter() as syncs:
            got, wall_n = _tp_streams(engine, prompts)
        launched = counts()
    finally:
        engine.shutdown()
    ties = sum(_tie_checked(ref, f"tp {label} prompt {i}", p, g, w)
               for i, (p, g, w) in enumerate(zip(prompts, got, want)))
    # the shortest and the longest prompt: flash's smallest and largest tiles
    diff = _tp_logits_diff(ref, engine, (min(prompts, key=len), max(prompts, key=len)))
    report = engine.mesh_report()
    peak = torch.cuda.max_memory_allocated(dev)
    missing = [n for n in expected if launched[n] == 0]
    if missing:
        raise AssertionError(f"tp {label}: kernels never launched at TP={shards}: {missing}")
    if not diff <= TP_LOGITS_LIMITS[label]:
        raise AssertionError(f"tp {label}: the largest logits difference {diff:.4g} between "
                             f"TP={shards} and TP=1 exceeds its limit {TP_LOGITS_LIMITS[label]}")
    if syncs.counts["torch-llm-engine"]:
        raise AssertionError(f"tp {label}: the dispatch thread waited for the card "
                             f"{syncs.counts['torch-llm-engine']} times")
    plan = report["memory"][str(dev)]["planned_bytes"]
    log(f"  tp {label}: {model} {quantization}/{kv_dtype} {layout}, {len(prompts)} greedy prompts "
        f"of {min(map(len, prompts))}-{max(map(len, prompts))} ids x {TP_TOKENS} tokens: TP={shards} "
        f"streams equal TP=1's ({ties} parted at a tie); largest logits difference "
        f"{diff:.4g} (limit {TP_LOGITS_LIMITS[label]}); decode block wall {wall_n:.2f} ms at TP={shards} against {wall_1:.2f} ms at "
        f"TP=1 ({wall_n / wall_1:.2f}x); peak allocated on {dev} {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before the "
        f"leg (both engines; the TP engine's plan {plan / 2**30:.2f} GiB); "
        f"launches {launched}; {time.time() - t0:.1f} s")
    return {"shards": shards, "ties": ties, "max_logits_diff": diff, "wall_block_ms": wall_n,
            "wall_block_ms_tp1": wall_1, "peak_allocated_bytes": {str(dev): peak},
            "held_before_bytes": {str(dev): held},
            "planned_bytes": {str(dev): plan}, "launches": launched}, engine


def _tp_answers(base) -> list:
    """TP_SERVER_REQUESTS greedy chat completions, one after another (each
    prefills alone, so two servers' rows see the same shapes); their
    texts."""
    texts = []
    for i in range(TP_SERVER_REQUESTS):
        status, body = _http(base, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": f"Question {i}: what is a GPU?"}],
            "max_tokens": 16, "temperature": 0})
        message = json.loads(body)["choices"][0]["message"] if status == 200 else {}
        if message.get("role") != "assistant":
            raise AssertionError(f"tp (c): request {i} answered HTTP {status} {body[:200]!r}")
        texts.append(message["content"])
    return texts


def _tp_card_server(log_path) -> tuple:
    """A server process at APP_ENGINE_TENSORPARALLELISM=TP_SHARDS_8B, its
    shards on distinct cards, once it holds its engine: (process, url)."""
    port = _free_port()
    env = dict(os.environ, APP_ENGINE_MODELCONFIGNAME=MODEL, APP_ENGINE_QUANTIZATION="int8",
               APP_ENGINE_KVCACHEDTYPE="bfloat16", APP_ENGINE_KVLAYOUT="paged",
               APP_ENGINE_MAXSEQLEN=str(TP_MAX_SEQ),
               APP_ENGINE_TENSORPARALLELISM=str(TP_SHARDS_8B))
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "generativeaiexamples_tpu_torch.engine.server",
             "--host", "127.0.0.1", "--port", str(port)],
            env=env, stdout=log_file, stderr=subprocess.STDOUT)
    base, t0 = f"http://127.0.0.1:{port}", time.time()
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"tp (c): the server exited with {proc.returncode}: "
                                 f"{open(log_path, errors='replace').read()[-3000:]}")
        try:
            status, text = _http(base, "GET", "/internal/ready", timeout=5)
            if status == 200 and json.loads(text).get("ready"):
                return proc, base
        except OSError:
            pass
        if time.time() - t0 > 600:
            proc.kill()
            raise AssertionError("tp (c): the server did not become ready in 600 s")
        time.sleep(0.5)


def _tp_server(dev, engine) -> dict:
    """(c): the OpenAI-compatible engine server in process over the TP=2
    recipe-A engine (its shards on this card) answers TP_SERVER_REQUESTS
    chat completions. Where the machine shows two cards, a server process
    started through the environment at TP=2 with its shards on distinct
    cards answers the same requests with the same texts (the same weights
    from seed 0, the same tiles and the same reduce, its partials copied
    between the cards)."""
    from generativeaiexamples_tpu_torch.engine.server import make_server

    t0 = time.time()
    server = make_server("127.0.0.1", 0, engine=engine)
    threading.Thread(target=server.serve_forever, name="smoke-http-tp", daemon=True).start()
    try:
        want = _tp_answers(f"http://127.0.0.1:{server.server_address[1]}")
    finally:
        server.shutdown()
        server.server_close()
    how = (f"in process over the TP={TP_SHARDS_8B} recipe-A engine of "
           f"create_mesh({TP_SHARDS_8B}, devices=[{dev}] * {TP_SHARDS_8B})")
    if torch.cuda.device_count() >= TP_SHARDS_8B:
        log_path = os.path.join(tempfile.gettempdir(), f"tp_server_{os.getpid()}.log")
        proc, base = _tp_card_server(log_path)
        try:
            got = _tp_answers(base)
        except AssertionError as exc:
            raise AssertionError(f"{exc}; the server's log ends: "
                                 f"{open(log_path, errors='replace').read()[-4000:]}") from None
        finally:
            proc.terminate()
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(60)
        if got != want:
            raise AssertionError(f"tp (c): the server on {TP_SHARDS_8B} cards answered {got!r}, "
                                 f"the one-card shards {want!r}")
        how += (f"; then a server process at APP_ENGINE_TENSORPARALLELISM={TP_SHARDS_8B}, shards "
                f"on distinct cards, gave the same {TP_SERVER_REQUESTS} texts")
    else:
        how += f" ({torch.cuda.device_count()} card visible: no distinct-card server)"
    log(f"  tp (c): the engine server answered {TP_SERVER_REQUESTS} chat completions {how} "
        f"({time.time() - t0:.1f} s)")
    return {"server": how, "requests": TP_SERVER_REQUESTS}


def phase_tp(dev, smi, seed=0) -> dict:
    """Tensor-parallel serving (module docstring, phase 16)."""
    import random

    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    t0 = time.time()
    rng = random.Random(seed * 1000 + 16)
    out = {"legs": {}}
    launches = collections.Counter()
    expected = {name: exp for name, _, _, _, exp in RECIPES}
    params = quant.init_packed_params_int8(llama.PRESETS[MODEL], seed, torch.bfloat16, dev)
    prompts = _tp_prompts(rng, TP_LENGTHS_8B)
    server_engine = None
    for name, quantization, kv_dtype, layout, _ in RECIPES:
        model, weights = MODEL, params
        if name in "BCD":
            layers = TP_LAYERS_BC if name in "BC" else CUT_LAYERS
            model = _cut_model(layers)
            weights = dict(params, layers=params["layers"][:layers])
        res, engine = tp_leg(dev, f"8b {name}", model, quantization, kv_dtype, layout, weights,
                             TP_SHARDS_8B, prompts, expected[name])
        launches.update(res.pop("launches"))
        out["legs"][f"8b_{name}"] = res
        if name == "A":
            server_engine = engine
        else:
            _free_engine(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    # (c) the engine server over the leg's TP=2 recipe-A engine again, on its
    # sharded weights (the leg shut it down)
    served = LLMEngine(server_engine.engine_config, params=server_engine.params,
                       mesh=server_engine._mesh)
    _free_engine(server_engine)
    try:
        reset_counts()
        out["server"] = _tp_server(dev, served)
        launches.update(counts())
    finally:
        served.shutdown()
        _free_engine(served)
    del params, served, server_engine
    gc.collect()
    torch.cuda.empty_cache()
    # (b) llama3-70b at full width, TP=8, 4 of 80 layers, all shards on one card
    model70 = f"{TP_MODEL_70B}-{TP_LAYERS_70B}-layers"
    llama.PRESETS[model70] = dataclasses.replace(llama.PRESETS[TP_MODEL_70B], num_layers=TP_LAYERS_70B)
    params70 = quant.init_packed_params_int8(llama.PRESETS[model70], seed, torch.bfloat16, dev)
    res, engine = tp_leg(dev, "70b A", model70, "int8", "bfloat16", "paged", params70, TP_SHARDS_70B,
                         _tp_prompts(rng, TP_LENGTHS_70B), expected["A"])
    launches.update(res.pop("launches"))
    out["legs"]["70b_A"] = res
    _free_engine(engine)
    del engine, params70
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["wall_s"] = time.time() - t0
    log(f"  tp launches in the phase (every shard's): {dict(launches)}")
    if out["wall_s"] > TP_BUDGET_S:
        log(f"  tp: the phase took {out['wall_s']:.1f} s, over its {TP_BUDGET_S:.0f} s budget")
    log(f"phase tp: ok ({out['wall_s']:.1f} s on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 17: checkpoints and fine-tuning

TRAIN_LAYERS = 4  # (a), (b), (e): 4 of llama3-8b's 32 layers
TRAIN_FILES = 2  # (a): the checkpoint's safetensors files
TRAIN_LENGTHS = (120, 300, 480, 900)  # greedy prompts; flash serves the three <= 512
TRAIN_TOKENS = 16
TRAIN_MAX_SEQ = 2048
TRAIN_BATCH = (4, 256)  # (d), (e): B x T, one fixed batch
TRAIN_LORA = {"rank": 16, "alpha": 32.0, "targets": ("wq", "wk", "wv", "wo")}
TRAIN_LORA_LR = 3e-4
TRAIN_LORA_STEPS = 6
TRAIN_SAVE_AT = 3  # (d): saved after step 3, restored, steps 4-6 again
TRAIN_SFT_LR = 1e-4
TRAIN_SFT_STEPS = 4
TRAIN_SFT_SAVE_AT = 2
# (d): step 0's loss is the base model's sft_loss (B = 0 makes the delta
# exactly zero; the same kernels on the same shapes), within f32 rounding
TRAIN_STEP0_RTOL = 1e-6
# (f): the largest |logits difference| between the merged dense model and
# the unmerged forward with adapters (bf16 weights rounded after the merge
# against the bf16 delta path), about twice its reading on NVIDIA H100
# 80GB HBM3 at 700 W (0.0625) and well under LOGITS_TOL, so a merge that
# drops or doubles a delta fails
TRAIN_MERGE_LIMIT = 0.15
TRAIN_MERGED_PROMPTS = 2  # (f): the first two of TRAIN_LENGTHS
TRAIN_CLI_STEPS = (4, 6)  # (g): a run, then --resume to the second count
TRAIN_BUDGET_S = 150.0


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float bits as integers)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(view), b.contiguous().view(view))
    return torch.equal(a, b)


def _same_tree(a, b) -> bool:
    """Two trees (dicts, lists, Shards of tensors) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and _bitwise(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return a == b


def _driven(engine, prompts, label, expected) -> tuple:
    """``engine``'s greedy streams with the kernel launch counts set to 0
    just before and read just after; every kernel of ``expected`` must
    have launched."""
    reset_counts()
    streams = _tp_streams(engine, prompts, TRAIN_TOKENS)[0]
    launched = counts()
    missing = [n for n in expected if launched[n] == 0]
    if missing:
        raise AssertionError(f"train {label}: kernels never launched: {missing}")
    return streams, launched


def _plain_greedy(params, cfg, prompt, tokens, vocab, stop_ids) -> tuple:
    """Greedy continuation of ``prompt`` on the plain path (the plain int8
    product and the einsum attention over the whole context, recomputed
    each token, no kernel): (tokens, each token's top-1 margin)."""
    from generativeaiexamples_tpu_torch.models import llama

    ids, out, margins = list(prompt), [], []
    dev = params["embed"].device
    for _ in range(tokens):
        x = torch.tensor([ids], device=dev)
        with torch.inference_mode():
            logits, _ = llama.prefill_layers(params, cfg, x, torch.tensor([len(ids)], device=dev),
                                             use_flash=False, quant_kernel=False)
        top2 = torch.topk(logits[0, :vocab].float(), 2)
        tok = int(top2.indices[0])
        out.append(tok)
        margins.append(float(top2.values[0] - top2.values[1]))
        ids.append(tok)
        if tok in stop_ids:
            break
    return out, margins


def _plain_tie_checked(label, got, want, margins) -> int:
    """``got`` (the kernel path) equals ``want`` (the plain path), or they
    part at a token whose plain top-1 margin is within LOGITS_TOL."""
    if got == want:
        return 0
    at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    margin = margins[at] if at < len(margins) else 0.0
    log(f"    {label}: parts from the plain path at token {at}, where the plain top-1 margin "
        f"is {margin:.4g} (tolerance {LOGITS_TOL})")
    if margin > LOGITS_TOL:
        raise AssertionError(f"train {label}: the kernel path's stream differs from the plain "
                             f"path's beyond a tie (margin {margin:.4g} > {LOGITS_TOL})")
    return 1


def _peak_reset(dev) -> int:
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return held


def _train_checkpoint(dev, tmp, seed, rng) -> dict:
    """(a) a bf16 HF checkpoint at llama3-8b width into recipes A and B's
    engines; (b) the same at TP=2."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.models import hf_loader, llama
    from generativeaiexamples_tpu_torch.ops import quant
    from generativeaiexamples_tpu_torch.parallel import create_mesh, sharding

    cfg = dataclasses.replace(llama.PRESETS[MODEL], num_layers=TRAIN_LAYERS)
    name = f"{MODEL}-{TRAIN_LAYERS}-layers"
    llama.PRESETS[name] = cfg
    ckpt = os.path.join(tmp, "llama")
    t0 = time.time()
    hf_loader.write_hf_checkpoint(cfg, ckpt, seed=seed, n_shards=TRAIN_FILES, dtype=torch.bfloat16,
                                  device=dev)
    write_s = time.time() - t0
    files = sorted(f for f in os.listdir(ckpt) if f.endswith(".safetensors"))
    sizes = [os.path.getsize(os.path.join(ckpt, f)) for f in files]
    log(f"  train (a): wrote {len(files)} files of {[round(s / 1e9, 3) for s in sizes]} GB "
        f"({sum(sizes) / 1e9:.2f} GB, bf16, {TRAIN_LAYERS} of 32 layers) in {write_s:.1f} s")
    ref = quant.quantize_params_int8(hf_loader.load_params(ckpt, cfg, torch.bfloat16, dev))
    prompts = _tp_prompts(rng, TRAIN_LENGTHS)
    expected = {n: exp for n, _, _, _, exp in RECIPES}
    out, launches = {"files_bytes": sizes, "write_s": write_s}, collections.Counter()
    engines, streams = {}, {}
    for recipe, quantization, kv_dtype in (("A", "int8", "bfloat16"), ("B", "w8a8", "int8")):
        base = dict(quantization=quantization, kv_cache_dtype=kv_dtype, kv_layout="paged",
                    max_seq_len=TRAIN_MAX_SEQ, tensor_parallelism=1)
        served = LLMEngine(EngineConfig(checkpoint_path=ckpt, **base), device=dev)
        given = None
        try:
            stats = dict(served.load_stats)
            if served.model_config != cfg:
                raise AssertionError(f"train (a) {recipe}: the engine serves {served.model_config}")
            if not _same_tree(served.params, ref):
                raise AssertionError(f"train (a) {recipe}: the streamed packs differ from "
                                     f"quantize_params_int8(load_params(...)) on the same files")
            got, launched = _driven(served, prompts, f"(a) {recipe}", expected[recipe])
            launches.update(launched)
            given = LLMEngine(EngineConfig(model_config_name=name, **base), device=dev, params=ref)
            want = _tp_streams(given, prompts, TRAIN_TOKENS)[0]
        finally:
            served.shutdown()
            if given is not None:
                given.shutdown()
        if got != want:
            raise AssertionError(f"train (a) {recipe}: the checkpoint engine's streams differ from "
                                 f"the engine given the same packs: {got} != {want}")
        gbs = sum(sizes) / stats["seconds"] / 1e9
        log(f"  train (a) {recipe}: {quantization}/{kv_dtype} engine from checkpoint_path alone: "
            f"load {stats['seconds']:.2f} s ({gbs:.2f} GB/s from the page cache, warm), "
            f"peak_host_bytes {stats['peak_host_bytes'] / 1e9:.3f} GB against the larger file's "
            f"{max(sizes) / 1e9:.3f} GB; packs byte-equal to quantize_params_int8(load_params); "
            f"{len(prompts)} greedy streams x {TRAIN_TOKENS} token-identical to the engine given "
            f"them; launches {launched}")
        out[recipe] = {"load_s": stats["seconds"], "load_gb_per_s": gbs,
                       "peak_host_bytes": stats["peak_host_bytes"], "launches": launched}
        engines[recipe], streams[recipe] = given, want
    # (b) TP=2 from the checkpoint, both shards on this card
    mesh = create_mesh(TP_SHARDS_8B, devices=[dev] * TP_SHARDS_8B)
    base = dict(quantization="int8", kv_cache_dtype="bfloat16", kv_layout="paged",
                max_seq_len=TRAIN_MAX_SEQ)
    tp = LLMEngine(EngineConfig(checkpoint_path=ckpt, tensor_parallelism=TP_SHARDS_8B, **base),
                   mesh=mesh)
    try:
        if not _same_tree(tp.params, sharding.shard_params(ref, mesh, repack_cfg=cfg)):
            raise AssertionError("train (b): the per-shard packs differ from shard_params of the "
                                 "single-device packs")
        got, launched = _driven(tp, prompts, "(b)", expected["A"])
        launches.update(launched)
    finally:
        tp.shutdown()
    # TP=1: (a)'s recipe-A engine given the same packs (shut down, its
    # weights kept for the tie margins and the logits)
    one = engines["A"]
    ties = sum(_tie_checked(one, f"train (b) prompt {i}", p, g, w)
               for i, (p, g, w) in enumerate(zip(prompts, got, streams["A"])))
    diff = _tp_logits_diff(one, tp, (min(prompts, key=len), max(prompts, key=len)))
    if not diff <= TP_LOGITS_LIMITS["8b A"]:
        raise AssertionError(f"train (b): the largest logits difference {diff:.4g} between TP=2 and "
                             f"TP=1 exceeds {TP_LOGITS_LIMITS['8b A']}")
    log(f"  train (b): TP={TP_SHARDS_8B} engine from the checkpoint: per-shard packs byte-equal to "
        f"shard_params of (a)'s; streams equal TP=1's ({ties} parted at a tie); largest logits "
        f"difference {diff:.4g} (limit {TP_LOGITS_LIMITS['8b A']}); launches {launched} "
        f"(every shard's)")
    out["tp"] = {"ties": ties, "max_logits_diff": diff, "launches": launched}
    for eng in (tp, *engines.values()):
        _free_engine(eng)
    del ref, tp, engines, one
    out["launches"] = dict(launches)
    return out


def _train_embedder(dev, tmp, seed) -> dict:
    """(c) arctic-embed-l from a HF BERT checkpoint through
    APP_EMBEDDINGS_CHECKPOINTPATH against the same tensors in memory."""
    from generativeaiexamples_tpu_torch import config as tconfig
    from generativeaiexamples_tpu_torch.engine import embedder as emb_mod
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder, create_embedder
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.utils import safetensors_io

    t0 = time.time()
    cfg = bert.BERT_PRESETS["arctic-embed-l"]
    params = bert.init_bert_params(cfg, torch.Generator(device=dev).manual_seed(seed), torch.bfloat16,
                                   dev)
    path = os.path.join(tmp, "arctic")
    os.makedirs(path)
    safetensors_io.save_file(bert.hf_tensors(params), os.path.join(path, "model.safetensors"))
    # a model name no earlier phase used: the factory caches an embedder by
    # (engine, url, name, device), as JAX's does, whatever its checkpoint
    config = tconfig.load_config({"APP_EMBEDDINGS_CHECKPOINTPATH": path,
                                  "APP_EMBEDDINGS_MODELNAME": "snowflake-arctic-embed-l"})
    loaded = create_embedder(config, device=dev)
    given = TorchEmbedder(model_name="arctic-embed-l", device=dev, params=params)
    texts = [f"passage {i}: " + " ".join(f"word{(i * 7 + j) % 97}" for j in range(20 + 9 * i))
             for i in range(8)]
    try:
        got, want = loaded.embed_documents(texts), given.embed_documents(texts)
        query = loaded.embed_query("which passage holds word42?")
        query_ref = given.embed_query("which passage holds word42?")
    finally:
        loaded.close()
        given.close()
        for key in [k for k, v in emb_mod._EMBEDDER_CACHE.items() if v is loaded]:
            del emb_mod._EMBEDDER_CACHE[key]
    if not (np.array_equal(got, want) and np.array_equal(query, query_ref)):
        raise AssertionError(f"train (c): the checkpoint embedder differs from the in-memory one "
                             f"(max {float(np.abs(got - want).max()):.3g})")
    log(f"  train (c): arctic-embed-l ({sum(t.numel() for t in bert.hf_tensors(params).values()) / 1e6:.0f}M "
        f"params, bf16) from APP_EMBEDDINGS_CHECKPOINTPATH: {len(texts)} passages and a query "
        f"bit-equal to the same tensors given in memory ({time.time() - t0:.1f} s)")
    return {"passages": len(texts), "s": time.time() - t0}


def _traced(fn) -> dict:
    """``fn()`` under torch.profiler's CUDA trace: the wall (host clock to a
    synchronize), the device's busy time (the union of its events), the
    idle share and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = device_trace.profile_events(prof)
    if not events:
        return {"wall_ms": wall, "busy_ms": None, "idle_share": None, "top": [],
                "not_measured": "no device events"}
    busy = device_trace.busy_ms((a, b) for _, a, b in events)
    by = collections.Counter()
    for name, a, b in events:
        by[name[:60]] += (b - a) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "events": len(events), "top": [(n, round(ms, 3)) for n, ms in by.most_common(5)]}


def _train_batch(rng, cfg) -> dict:
    B, T = TRAIN_BATCH
    tokens = torch.tensor([[rng.randrange(1, 256) for _ in range(T)] for _ in range(B)])
    mask = torch.ones((B, T))
    mask[:, : T // 8] = 0.0  # a prompt of T/8 ids a row, unsupervised
    return tokens, mask


def _train_lora(dev, tmp, seed, rng) -> tuple:
    """(d) LoRA at full width and depth: returns its numbers, the base,
    the adapters and the batch for (e) and (f)."""
    from generativeaiexamples_tpu_torch.models import llama, lora, train
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager

    cfg = llama.PRESETS[MODEL]
    t0 = time.time()
    base = llama.init_params(cfg, seed, torch.bfloat16, dev)
    leaves = train.tree_leaves(base)
    before = [(t._version, t.data_ptr(), int(t.view(torch.int16).sum(dtype=torch.int64)))
              for t in leaves]
    tokens, mask = _train_batch(rng, cfg)
    batch = {"tokens": tokens.to(dev), "loss_mask": mask.to(dev)}
    lcfg = lora.LoRAConfig(**TRAIN_LORA)
    optimizer = train.make_optimizer(learning_rate=TRAIN_LORA_LR)

    def fresh(s):
        ad = train.trainable(lora.init_lora_params(
            cfg, lcfg, torch.Generator(device=dev).manual_seed(s), torch.bfloat16, dev))
        return train.TrainState(params=ad, opt_state=optimizer.init(ad),
                                step=torch.zeros((), dtype=torch.int32, device=dev))

    step = train.make_lora_train_step(cfg, lcfg, optimizer)
    with torch.no_grad():
        base_loss = float(train.sft_loss(base, cfg, batch["tokens"], batch["loss_mask"]))
    held = _peak_reset(dev)
    state, losses, times = fresh(seed), [], []
    mgr = CheckpointManager(os.path.join(tmp, "lora_ckpt"))
    for i in range(TRAIN_LORA_STEPS):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        state, loss = step(state, base, batch)
        losses.append(float(loss))
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t1)
        if i + 1 == TRAIN_SAVE_AT:
            mgr.save(TRAIN_SAVE_AT, state)
    peak = torch.cuda.max_memory_allocated(dev)
    resumed = mgr.restore(fresh(seed + 1))
    for _ in range(TRAIN_SAVE_AT, TRAIN_LORA_STEPS):
        resumed, _ = step(resumed, base, batch)
    # one more step, traced: where a step's time goes (its result unused)
    trace = _traced(lambda: step(resumed, base, batch))
    if abs(losses[0] - base_loss) > TRAIN_STEP0_RTOL * abs(base_loss):
        raise AssertionError(f"train (d): step 0's loss {losses[0]!r} is not the base's {base_loss!r}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train (d): the loss did not fall: {losses}")
    after = [(t._version, t.data_ptr(), int(t.view(torch.int16).sum(dtype=torch.int64)))
             for t in leaves]
    if after != before:
        raise AssertionError("train (d): a base weight was written by the LoRA steps")
    if not (_same_tree(resumed.params, state.params) and int(resumed.step) == TRAIN_LORA_STEPS):
        raise AssertionError(f"train (d): the adapters resumed from step {TRAIN_SAVE_AT} differ from "
                             f"the uninterrupted run's")
    step_ms = 1e3 * statistics.median(times[1:])
    B, T = TRAIN_BATCH
    log(f"  train (d): LoRA r={lcfg.rank} on {','.join(lcfg.targets)}, llama3-8b full width and "
        f"depth, bf16, B={B} T={T}, remat: losses {[round(x, 4) for x in losses]} (step 0 = the "
        f"base's {base_loss:.4f}); base weights unchanged bit for bit; resumed from step "
        f"{TRAIN_SAVE_AT} bitwise the uninterrupted adapters; {step_ms:.1f} ms a step (median of "
        f"steps 2-{TRAIN_LORA_STEPS}; each {[round(1e3 * x, 1) for x in times]}), "
        f"{B * T / step_ms * 1e3:.0f} tokens/s; peak allocated {peak / 2**30:.2f} GiB "
        f"({(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} held); a traced step: wall "
        f"{trace['wall_ms']:.1f} ms, device busy {trace['busy_ms']} ms, idle share "
        f"{trace['idle_share']}, {trace.get('events')} device events, the most device time "
        f"{trace['top']} ({time.time() - t0:.1f} s)")
    numbers = {"losses": losses, "base_loss": base_loss, "step_ms": step_ms,
               "step_times_ms": [1e3 * x for x in times], "tokens_per_s": B * T / step_ms * 1e3,
               "peak_allocated_bytes": peak, "held_before_bytes": held, "traced_step": trace}
    return numbers, base, state.params, batch


def _train_sft(dev, tmp, base, batch) -> dict:
    """(e) SFT over every weight of 4 of the 32 layers (the embedding and
    the head whole), AdamW, a resume within its tolerance."""
    from generativeaiexamples_tpu_torch.models import llama, train
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager

    t0 = time.time()
    cfg = dataclasses.replace(llama.PRESETS[MODEL], num_layers=TRAIN_LAYERS)
    part = dict(base, layers=base["layers"][:TRAIN_LAYERS])
    optimizer = train.make_optimizer(learning_rate=TRAIN_SFT_LR)
    step = train.make_train_step(cfg, optimizer)

    def fresh():
        params = train.trainable(part)
        return train.TrainState(params=params, opt_state=optimizer.init(params),
                                step=torch.zeros((), dtype=torch.int32, device=dev))

    held = _peak_reset(dev)
    state, losses, times = fresh(), [], []
    mgr = CheckpointManager(os.path.join(tmp, "sft_ckpt"))
    for i in range(TRAIN_SFT_STEPS):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t1)
        if i + 1 == TRAIN_SFT_SAVE_AT:
            mgr.save(TRAIN_SFT_SAVE_AT, state)
    peak = torch.cuda.max_memory_allocated(dev)
    resumed = mgr.restore(fresh())
    resumed_losses = []
    for _ in range(TRAIN_SFT_SAVE_AT, TRAIN_SFT_STEPS):
        resumed, loss = step(resumed, batch)
        resumed_losses.append(float(loss))
    # two AdamW steps after the restore each move an element by at most
    # ~lr (its update is m/(sqrt(v)+eps), about +-1) on either side, and
    # a bf16 parameter rounds to one ulp of the largest weight
    pmax = max(float(t.detach().abs().max()) for t in train.tree_leaves(state.params))
    ulp = 2.0 ** (np.floor(np.log2(pmax)) - 7)
    limit = 2 * (TRAIN_SFT_STEPS - TRAIN_SFT_SAVE_AT) * TRAIN_SFT_LR + ulp
    diff = max(float((a.detach().float() - b.detach().float()).abs().max())
               for a, b in zip(train.tree_leaves(resumed.params), train.tree_leaves(state.params)))
    bitwise = _same_tree(resumed.params, state.params)
    loss_rel = abs(resumed_losses[-1] - losses[-1]) / abs(losses[-1])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train (e): the loss did not fall: {losses}")
    if diff > limit or loss_rel > 1e-3 or resumed_losses[0] != losses[TRAIN_SFT_SAVE_AT]:
        raise AssertionError(f"train (e): the resumed run differs beyond its tolerance: weights "
                             f"{diff:.3g} (limit {limit:.3g}), losses {resumed_losses} against "
                             f"{losses[TRAIN_SFT_SAVE_AT:]}")
    step_ms = 1e3 * statistics.median(times[1:])
    n = llama.count_params(part)
    log(f"  train (e): SFT over all {n / 1e9:.2f}B weights of llama3-8b at {TRAIN_LAYERS} of 32 "
        f"layers, bf16, AdamW lr {TRAIN_SFT_LR}: losses {[round(x, 4) for x in losses]}; resumed from "
        f"step {TRAIN_SFT_SAVE_AT}: losses {[round(x, 4) for x in resumed_losses]}, weights within "
        f"{diff:.3g} of the uninterrupted run's (limit {limit:.3g}; bitwise {bitwise}); "
        f"{step_ms:.1f} ms a step, peak allocated {peak / 2**30:.2f} GiB "
        f"({(peak - held) / 2**30:.2f} above the {held / 2**30:.2f} held) ({time.time() - t0:.1f} s)")
    del state, resumed
    return {"losses": losses, "resumed_losses": resumed_losses, "max_weight_diff": diff,
            "limit": float(limit), "bitwise": bitwise, "step_ms": step_ms,
            "peak_allocated_bytes": peak}


def _train_merge(dev, base, adapters, batch, base_loss, rng) -> dict:
    """(f) merge (d)'s adapters, hold the merged logits to the unmerged
    forward, pack to int8 and serve through recipe A's engine."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.models import llama, lora, train
    from generativeaiexamples_tpu_torch.ops import quant

    t0 = time.time()
    cfg = llama.PRESETS[MODEL]
    lcfg = lora.LoRAConfig(**TRAIN_LORA)
    adapters = train.frozen(adapters)
    merged = lora.merge(base, adapters, lcfg)
    tokens = batch["tokens"][:1]
    pos = torch.arange(tokens.shape[1], device=dev)[None]
    with torch.no_grad():
        unmerged = llama.forward(base, cfg, tokens, pos, lora=adapters, lora_scale=lcfg.scale)
        dense = llama.forward(merged, cfg, tokens, pos)
        merged_loss = float(train.sft_loss(merged, cfg, batch["tokens"], batch["loss_mask"]))
    gap = _max_err(dense, unmerged)
    del unmerged, dense
    log(f"  train (f): merged dense logits against the unmerged forward with adapters: largest "
        f"|difference| {gap:.4g} (limit {TRAIN_MERGE_LIMIT}); merged loss {merged_loss:.4f} "
        f"against the base's {base_loss:.4f}")
    if not gap <= TRAIN_MERGE_LIMIT:
        raise AssertionError(f"train (f): merged logits {gap:.4g} from the unmerged forward "
                             f"(limit {TRAIN_MERGE_LIMIT})")
    if not merged_loss < base_loss:
        raise AssertionError(f"train (f): the merged loss {merged_loss} is not below the base's "
                             f"{base_loss}")
    packed = quant.quantize_params_int8(merged)
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    engine = LLMEngine(EngineConfig(model_config_name=MODEL, quantization="int8",
                                    kv_cache_dtype="bfloat16", kv_layout="paged",
                                    max_seq_len=TRAIN_MAX_SEQ, tensor_parallelism=1),
                       device=dev, params=packed)
    prompts = _tp_prompts(rng, TRAIN_LENGTHS[:TRAIN_MERGED_PROMPTS])
    expected = dict((n, e) for n, _, _, _, e in RECIPES)["A"]
    try:
        got, launched = _driven(engine, prompts, "(f)", expected)
        vocab, stops = engine._sample_vocab, set(engine.tokenizer.stop_ids())
    finally:
        engine.shutdown()
    ties = 0
    for i, (prompt, stream) in enumerate(zip(prompts, got)):
        want, margins = _plain_greedy(packed, cfg, prompt, TRAIN_TOKENS, vocab, stops)
        ties += _plain_tie_checked(f"(f) prompt {i}", stream, want, margins)
    _free_engine(engine)
    log(f"  train (f): the merged model packed to int8 and served by recipe A's engine (32 "
        f"layers): {len(prompts)} greedy streams equal the plain path's on the same packs "
        f"({ties} parted at a tie); launches {launched} ({time.time() - t0:.1f} s)")
    return {"max_logits_gap": gap, "merged_loss": merged_loss, "base_loss": base_loss,
            "ties": ties, "launches": launched}


def _finetune_here(argv) -> tuple:
    """``tools/finetune.py``'s ``main(argv)`` in this process (no child
    process to start and import): its exit code, standard output and
    standard error."""
    import contextlib
    import io

    from generativeaiexamples_tpu_torch.tools import finetune

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = finetune.main(list(argv))
    gc.collect()
    torch.cuda.empty_cache()
    return rc, out.getvalue(), err.getvalue()


def _train_cli(tmp, device="cuda") -> dict:
    """(g) the finetune CLI on the card, in this process
    (:func:`_finetune_here`; each ran in a child process before phase 20): a LoRA
    run with a checkpoint and a merge, then --resume to more steps."""
    data = os.path.join(tmp, "data.jsonl")
    with open(data, "w", encoding="utf-8") as fh:
        for i in range(8):
            fh.write(json.dumps({"prompt": f"q{i}: what is a GPU?", "response": "a card of SMs"}) + "\n")
    ck, merged = os.path.join(tmp, "cli_ckpt"), os.path.join(tmp, "merged.npz")
    out = {}
    for steps, extra in ((TRAIN_CLI_STEPS[0], ["--merge-out", merged]),
                         (TRAIN_CLI_STEPS[1], ["--resume"])):
        t0 = time.time()
        rc, stdout, stderr = _finetune_here(
            ["--model", "debug", "--data", data, "--mode", "lora", "--steps", str(steps),
             "--batch-size", "2", "--seq-len", "32", "--ckpt-dir", ck, "--save-every", "2",
             "--log-every", "1", "--device", device, *extra])
        lines = stdout.strip().splitlines()
        try:
            last = json.loads(lines[-1])
        except (IndexError, ValueError):
            last = {}
        if rc != 0 or last.get("steps") != steps or "final_loss" not in last:
            raise AssertionError(f"train (g): finetune {' '.join(extra)} exited {rc}, "
                                 f"last line {lines[-1:]!r}; stderr ends {stderr[-2000:]!r}")
        if "--resume" in extra and f"resumed from step {TRAIN_CLI_STEPS[0]}" not in stderr:
            raise AssertionError("train (g): --resume did not start from the saved step")
        out["resume" if "--resume" in extra else "run"] = {**last, "s": time.time() - t0}
    if not os.path.exists(merged):
        raise AssertionError("train (g): no merged npz was written")
    log(f"  train (g): generativeaiexamples_tpu_torch.tools.finetune main() --model debug --mode "
        f"lora --device {device}: {TRAIN_CLI_STEPS[0]} steps, final loss {out['run']['final_loss']:.4f} "
        f"({out['run']['s']:.1f} s, in this process), then --resume to {TRAIN_CLI_STEPS[1]}: "
        f"final loss {out['resume']['final_loss']:.4f} ({out['resume']['s']:.1f} s)")
    return out


def phase_train(dev, smi, seed=0, scratch=None) -> dict:
    """Checkpoints and fine-tuning (module docstring, phase 17)."""
    import random

    t0 = time.time()
    rng = random.Random(seed * 1000 + 17)
    tmp = tempfile.mkdtemp(prefix="train_", dir=scratch)
    out = {}
    try:
        out["checkpoint"] = _train_checkpoint(dev, tmp, seed, rng)
        gc.collect()
        torch.cuda.empty_cache()
        out["embedder"] = _train_embedder(dev, tmp, seed)
        out["lora"], base, adapters, batch = _train_lora(dev, tmp, seed, rng)
        out["sft"] = _train_sft(dev, tmp, base, batch)
        gc.collect()
        torch.cuda.empty_cache()
        out["merge"] = _train_merge(dev, base, adapters, batch, out["lora"]["base_loss"], rng)
        del base, adapters
        gc.collect()
        torch.cuda.empty_cache()
        out["cli"] = _train_cli(tmp, dev.type)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = collections.Counter(out["checkpoint"].pop("launches"))
    launches.update(out["merge"]["launches"])
    out["launches"] = dict(launches)
    out["wall_s"] = time.time() - t0
    log(f"  train launches in the phase: {dict(launches)}")
    if out["wall_s"] > TRAIN_BUDGET_S:
        log(f"  train: the phase took {out['wall_s']:.1f} s, over its {TRAIN_BUDGET_S:.0f} s budget")
    log(f"phase train: ok ({out['wall_s']:.1f} s on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 18: the paths served across shards

TPX_SHARDS = 2
TPX_LAYERS = 8  # (a)-(d): 8 of llama3-8b's 32 layers
TPX_MAX_SEQ = 2048
TPX_SPEC_REQUESTS = 4  # copy_heavy prompts (512 ids), greedy
TPX_SPEC_TOKENS = 24
# recipe -> the proposers its TP=2 engine runs after ``off``
TPX_SPEC_LEGS = {"A": ("lookup", "draft_model"), "D": ("lookup",)}
TPX_DRAIN_RECIPES = "AC"
TPX_DRAIN_TOKENS = 48
TPX_DRAIN_FAULT = dict(at=1, count=0, value=0.05)  # engine.dispatch delay: live at the drain
TPX_TIER_QUERIES = 8
TPX_PROFILE_LAYERS = CUT_LAYERS  # (e), since phase 21 (it ran llama3-8b at full depth before)
TPX_PROFILE_BATCH = 8
TPX_PROFILE_SEQ = 1024
TPX_PROFILE_PROMPT = 128
TPX_PROFILE_SECONDS = 1.0  # JAX's default window: 2-3 decode blocks of 8 steps at B = 8
TPX_PREFILL_IDS = 512  # one 512-bucket prefill (prefill_chunk 512)
TPX_PROFILE_TRIES = 3  # CUPTI can drop a session's events: capture again
TPX_PROFILE_CHILD_S = 600  # the time limit of (e)'s process for one shard count
TPX_BUDGET_S = 120.0


def _tpx_config(name, model, **kw) -> EngineConfig:
    """Recipe ``name``'s engine config at phase 18's shapes (one config a
    recipe: its TP=1 and TP=2 engines share the snapshot fingerprint)."""
    _, quantization, kv_dtype, layout, _ = next(r for r in RECIPES if r[0] == name)
    return EngineConfig(model_config_name=model, quantization=quantization, kv_cache_dtype=kv_dtype,
                        kv_layout=layout, max_batch_size=8, max_seq_len=TPX_MAX_SEQ, page_size=128,
                        prefill_chunk=512, decode_block=8, tensor_parallelism=1, **kw)


def _tpx_engine(cfg, params, dev, shards):
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.parallel import create_mesh

    if shards == 1:
        return LLMEngine(cfg, device=dev, params=params)
    return LLMEngine(cfg, params=params, mesh=create_mesh(shards, devices=[dev] * shards))


def _tpx_wave(engine, prompts, params) -> list:
    """``prompts`` admitted as one wave (``params`` each, or one a prompt);
    their transcripts, stop ids included."""
    params = params if isinstance(params, list) else [params] * len(prompts)
    with engine.hold_admissions():
        reqs = [engine.submit(p, sp) for p, sp in zip(prompts, params)]
    for r in reqs:
        _drain_ids(r.out_queue)
        if r.error is not None:
            raise AssertionError(f"a request failed: {r.error!r}")
    return [list(r.emitted) for r in reqs]


def _tpx_ties(engine, label, prompts, got, want) -> int:
    return sum(_tie_checked(engine, f"{label} stream {i}", p, g, w)
               for i, (p, g, w) in enumerate(zip(prompts, got, want)))


def _tpx_spec(dev, name, cfg, params, prompts, out, launches) -> None:
    """(a) one recipe: its TP=2 engine ``off`` then each proposer, and a
    TP=1 engine on ``lookup``; every stream against the TP=2 ``off``
    stream (ties apart), the verify's shapes and launches recorded."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    greedy = SamplingParams(temperature=0.0, max_tokens=TPX_SPEC_TOKENS)
    legs, ref, engine = {}, None, None
    runs = [(TPX_SHARDS, None)] + [(TPX_SHARDS, p) for p in TPX_SPEC_LEGS[name]] + [(1, "lookup")]
    try:
        for shards, proposer in runs:
            if engine is None or engine.tp_shards != shards:
                if engine is not None:
                    engine.shutdown()
                    _free_engine(engine)
                engine = _tpx_engine(cfg, params, dev, shards)
            ref = _tpx_spec_leg(engine, name, cfg, shards, proposer, prompts, greedy, ref, legs,
                                launches)
    finally:
        if engine is not None:
            engine.shutdown()
            _free_engine(engine)
    out[name] = legs


def _tpx_spec_leg(engine, name, cfg, shards, proposer, prompts, greedy, ref, legs, launches):
    """One leg of (a) on ``engine``; returns the reference streams (this
    leg's when it is the first)."""
    label = f"tpx (a) {name} TP={shards} {proposer or 'off'}"
    t0 = time.time()
    if proposer is None:
        engine.set_spec_decode(False)
    elif not (engine.set_spec_decode(True) and engine.set_spec_proposer(proposer) == proposer):
        raise AssertionError(f"{label}: the proposer is not served")
    s0 = engine.stats()
    reset_counts()
    with SyncCounter() as syncs, _ShapeLog() as shapes:
        got = _tpx_wave(engine, prompts, greedy)
        _settle(engine)
    launched = counts()
    launches.update(launched)
    s1 = engine.stats()
    d = {k: s1[k] - s0[k] for k in ("decode_dispatches", "spec_verify_dispatches",
                                    "spec_drafted_tokens", "spec_accepted_tokens",
                                    "spec_draft_dispatches", "tokens_generated")}
    dispatch = {k: v for (th, k), v in syncs.kinds.items() if th == "torch-llm-engine"}
    if dispatch.get(None, 0):
        raise AssertionError(f"{label}: {dispatch[None]} synchronizing calls on the dispatch "
                             f"thread outside the spec read backs")
    is_ref = ref is None
    ties = 0 if is_ref else _tpx_ties(engine, label, prompts, got, ref)
    ref = got if is_ref else ref
    verify_T = sorted({t for (_, t), n in shapes.paged.items() if t > 1})
    verify_M = sorted(m for m in shapes.int8 if m > 8)
    if proposer is not None:
        if d["spec_verify_dispatches"] < 1 or VERIFY_M not in verify_M:
            raise AssertionError(f"{label}: no verify at M = {VERIFY_M} ({d}, M {verify_M})")
        if cfg.kv_layout == "paged" and 9 not in verify_T:
            raise AssertionError(f"{label}: the paged verify did not read T = 9 ({verify_T})")
    if proposer == "draft_model" and (d["spec_draft_dispatches"] < 1
                                      or engine._draft.shards != TPX_SHARDS):
        raise AssertionError(f"{label}: the draft did not run on {TPX_SHARDS} shards")
    expected = next(r[4] for r in RECIPES if r[0] == name)
    missing = [k for k in expected if launched[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    row = {"ties": ties, "acceptance": d["spec_accepted_tokens"] / max(1, d["spec_drafted_tokens"]),
           "tokens_per_dispatch": d["tokens_generated"] / max(1, d["decode_dispatches"]),
           "verify_dispatches": d["spec_verify_dispatches"],
           "draft_dispatches": d["spec_draft_dispatches"],
           "verify_launches": {"int8_matmul_M72": shapes.int8.get(VERIFY_M, 0),
                               "paged_T9": sum(n for (_, t), n in shapes.paged.items() if t == 9)},
           "launches": {k: v for k, v in launched.items() if v}, "s": time.time() - t0}
    legs[f"TP{shards}_{proposer or 'off'}"] = row
    log(f"  {label}: {len(prompts)} copy_heavy prompts x {TPX_SPEC_TOKENS} tokens: "
        f"{'the reference' if is_ref else f'equal to TP={TPX_SHARDS} off'}"
        f"{f' ({ties} parted at a tie)' if ties else ''}; acceptance {row['acceptance']:.3f} "
        f"({d['spec_accepted_tokens']}/{d['spec_drafted_tokens']}), "
        f"{row['tokens_per_dispatch']:.3f} tokens a dispatch, {d['spec_verify_dispatches']} "
        f"verifies, {d['spec_draft_dispatches']} draft dispatches; verify launches: "
        f"int8_matmul at M={VERIFY_M} {row['verify_launches']['int8_matmul_M72']}, paged at "
        f"T=9 {row['verify_launches']['paged_T9']}; dispatch-thread syncs {dispatch or 'none'}; "
        f"{row['s']:.1f} s")
    return ref


def _tpx_drain(dev, name, cfg, params, rng, out, launches) -> None:
    """(b) one recipe at TP=2: the undrained streams, then the same
    requests drained mid-decode; each document restored into a fresh TP=2
    engine and into a TP=1 engine, spooled tokens plus continuation
    against the undrained stream (ties apart)."""
    from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.utils import faults

    prompts = _tp_prompts(rng, (140, 300, 520, 900))
    params_ = [SamplingParams(temperature=0.0, max_tokens=TPX_DRAIN_TOKENS),
               SamplingParams(temperature=0.7, top_p=0.9, max_tokens=TPX_DRAIN_TOKENS, seed=5),
               SamplingParams(temperature=0.0, max_tokens=TPX_DRAIN_TOKENS),
               SamplingParams(temperature=0.7, top_p=0.9, max_tokens=TPX_DRAIN_TOKENS, seed=6)]
    engine = _tpx_engine(cfg, params, dev, TPX_SHARDS)
    try:
        reset_counts()
        want = _tpx_wave(engine, prompts, params_)
        launches.update(counts())
        faults.configure("engine.dispatch", "delay", **TPX_DRAIN_FAULT)
        try:
            with engine.hold_admissions():
                reqs = [engine.submit(p, sp) for p, sp in zip(prompts, params_)]
            deadline = time.time() + 120
            while not all(r.generated for r in reqs):
                if time.time() > deadline:
                    raise AssertionError(f"tpx (b) {name}: no first tokens in 120 s")
                time.sleep(0.005)
            t0 = time.time()
            summary = engine.drain()
            drain_s = time.time() - t0
        finally:
            faults.reset()
        for r in reqs:
            _drain_ids(r.out_queue)
    finally:
        engine.shutdown()
        _free_engine(engine)
    # a stream that sampled a stop id before the drain ended on its own
    # (random weights): it equals its undrained stream, the rest spooled
    live = [i for i, r in enumerate(reqs) if r.error is not None]
    for i, r in enumerate(reqs):
        if r.error is None and list(r.emitted) != want[i]:
            raise AssertionError(f"tpx (b) {name}: stream {i} ended before the drain and differs "
                                 f"from its undrained run")
    if len(live) < 2 or summary["spooled"] != len(live) or summary["replay_only"]:
        raise AssertionError(f"tpx (b) {name}: the drain spooled {summary} of {len(live)} live")
    docs = [engine.snapshot_spool.load_doc(reqs[i].error.snapshot_id) for i in live]
    want, prompts = [want[i] for i in live], [prompts[i] for i in live]
    hkv = next(iter(docs))["geometry"]["num_kv_heads"]
    if hkv != llama.PRESETS[cfg.model_config_name].num_kv_heads:
        raise AssertionError(f"tpx (b) {name}: the document holds {hkv} KV heads, not the model's")
    nbytes = [len(json.dumps(doc)) for doc in docs]
    res = {"drain_s": drain_s, "document_bytes": nbytes, "emitted_at_drain":
           [len(doc["emitted"]) for doc in docs]}
    for shards in (TPX_SHARDS, 1):
        target = _tpx_engine(cfg, params, dev, shards)
        try:
            reset_counts()
            lat, ties = [], 0
            for i, (doc, w, p) in enumerate(zip(docs, want, prompts)):
                t0 = time.time()
                new, _, prior, mode = target.restore_snapshot(rs.RequestSnapshot.from_doc(doc))
                lat.append(time.time() - t0)
                _drain_ids(new.out_queue)
                if mode != "restore" or new.error is not None:
                    raise AssertionError(f"tpx (b) {name} into TP={shards}: mode {mode}, "
                                         f"{new.error!r}")
                ties += _tie_checked(target, f"tpx (b) {name} into TP={shards} stream {i}", p,
                                     list(new.emitted), w)
            launches.update(counts())
        finally:
            target.shutdown()
            _free_engine(target)
        res[f"restore_TP{shards}"] = {"p50_s": statistics.median(lat), "max_s": max(lat),
                                      "ties": ties}
    out[name] = res
    log(f"  tpx (b) {name} at TP={TPX_SHARDS}: {len(docs)} streams drained after "
        f"{min(res['emitted_at_drain'])}-{max(res['emitted_at_drain'])} tokens in {drain_s:.3f} s, "
        f"documents {min(nbytes)}-{max(nbytes)} bytes ({hkv} KV heads, the model's); restored into "
        f"a fresh TP={TPX_SHARDS} engine (p50 {res[f'restore_TP{TPX_SHARDS}']['p50_s']:.4f} s, "
        f"{res[f'restore_TP{TPX_SHARDS}']['ties']} ties) and a TP=1 engine (p50 "
        f"{res['restore_TP1']['p50_s']:.4f} s, {res['restore_TP1']['ties']} ties): spooled + "
        f"continued tokens equal to the undrained TP={TPX_SHARDS} streams")


def _tpx_disagg(dev, cfg, params, rng, out, launches) -> None:
    """(c) disagg at TP=2 against unified at TP=2: the same wave's streams
    (ties apart), one handoff a request, no recompute; the tier plan."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams
    from generativeaiexamples_tpu_torch.engine.scheduler import handoff

    prompts = _tp_prompts(rng, (120, 400, 700, 1500))
    greedy = SamplingParams(temperature=0.0, max_tokens=TPX_SPEC_TOKENS)
    runs = {}
    for policy in ("unified", "disagg"):
        engine = _tpx_engine(dataclasses.replace(cfg, scheduler_policy=policy), params, dev,
                             TPX_SHARDS)
        try:
            h0 = handoff.metrics_snapshot()
            reset_counts()
            runs[policy] = (_tpx_wave(engine, prompts, greedy), engine.scheduler.describe())
            launches.update(counts())
            h1 = handoff.metrics_snapshot()
            if policy == "disagg":
                ties = _tpx_ties(engine, "tpx (c) disagg", prompts, runs[policy][0],
                                 runs["unified"][0])
        finally:
            engine.shutdown()
            _free_engine(engine)
    handed = h1["handoffs"] - h0["handoffs"]
    if handed != len(prompts) or h1["handoff_recompute"] != h0["handoff_recompute"]:
        raise AssertionError(f"tpx (c): {handed} handoffs, recompute "
                             f"{h1['handoff_recompute'] - h0['handoff_recompute']}")
    plan = {k: runs["disagg"][1][k] for k in ("prefill_tier_devices", "decode_tier_devices",
                                              "shared_pool")}
    out["disagg"] = {"ties": ties, "handoffs": handed, "plan": plan}
    log(f"  tpx (c) disagg at TP={TPX_SHARDS}: {len(prompts)} greedy streams of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} ids equal to unified's ({ties} parted "
        f"at a tie), {handed} handoffs, no recompute; tier plan {plan} (advisory: dispatch on the "
        f"serving mesh, one shared pool)")


def _tpx_tier(dev, cfg, params, rng, out, seed) -> None:
    """(d) the retrieval tier beside the decoding TP=2 engine (the process
    engine): hash embeddings into the in-process store on the card, 8
    concurrent queries through the tier against the synchronous path,
    scores within SEARCH_SCORE_TOL and tie runs as sets."""
    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import llm_engine, retrieval_tier
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    env = {"APP_EMBEDDINGS_MODELENGINE": "hash", "APP_RANKING_MODELENGINE": "",
           "APP_RETRIEVER_NRPIPELINE": "hybrid", "APP_RETRIEVER_SCORETHRESHOLD": "0",
           "APP_VECTORSTORE_NAME": "tpu", "APP_TEXTSPLITTER_CHUNKSIZE": "48",
           "APP_TEXTSPLITTER_CHUNKOVERLAP": "16", "APP_RETRIEVER_BACKEND": "off"}
    saved = {k: os.environ.get(k) for k in list(env) + ["APP_VECTORSTORE_PERSISTDIR"]}
    tmp = tempfile.mkdtemp(prefix="tpx_tier_")
    engine = _tpx_engine(cfg, params, dev, TPX_SHARDS)
    prev = llm_engine._ENGINE
    try:
        os.environ.update(env, APP_VECTORSTORE_PERSISTDIR=os.path.join(tmp, "vs"))
        runtime.reset_runtime()
        runtime.set_device(dev)
        acfg = config_mod.load_config()
        docs = _rag_corpus(np.random.RandomState(seed + 18))
        for d, sentences in enumerate(docs):
            path = os.path.join(tmp, f"doc{d:02d}.txt")
            with open(path, "w") as fh:
                fh.write(" ".join(sentences))
            runtime.ingest_file(path, os.path.basename(path), config=acfg)
        queries = [docs[i][i % len(docs[i])] for i in range(TPX_TIER_QUERIES)]
        sync = [runtime.retrieve(q, config=acfg) for q in queries]
        tier_cfg = dataclasses.replace(acfg, retriever=dataclasses.replace(
            acfg.retriever, backend="tier"))
        llm_engine._ENGINE = engine
        long = engine.submit(_tp_prompts(rng, (600,))[0],
                             SamplingParams(temperature=0.0, max_tokens=256))
        c0 = dict(retrieval_tier.counters)
        got = _concurrently({i: lambda q=q: runtime.retrieve(q, config=tier_cfg)
                             for i, q in enumerate(queries)})
        c1 = dict(retrieval_tier.counters)
        decoding = not long.finished
        _drain_ids(long.out_queue)
    finally:
        llm_engine._ENGINE = prev
        retrieval_tier.close_tier()
        runtime.reset_runtime()
        engine.shutdown()
        _free_engine(engine)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config_mod.get_config.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)

    def as_body(hits):
        return 200, json.dumps({"chunks": [{"filename": h.chunk.source, "content": h.chunk.text,
                                            "score": h.score} for h in hits]})

    wrong = [i for i in range(len(queries)) if not _same_search(as_body(got[i]), as_body(sync[i]))]
    if wrong:
        raise AssertionError(f"tpx (d): tier hits differ from the synchronous path's for {wrong}")
    queried = c1.get("queries", 0) - c0.get("queries", 0)
    if queried != len(queries):
        raise AssertionError(f"tpx (d): {queried} of {len(queries)} queries went through the tier")
    out["tier"] = {"queries": queried, "waves": c1.get("waves", 0) - c0.get("waves", 0),
                   "dispatches": c1.get("dispatches", 0) - c0.get("dispatches", 0),
                   "engine_decoding": decoding}
    log(f"  tpx (d) retrieval tier beside the TP={TPX_SHARDS} process engine "
        f"({'decoding' if decoding else 'idle by then'}): {queried} concurrent queries in "
        f"{out['tier']['waves']} waves, {out['tier']['dispatches']} ANN dispatches, every answer "
        f"equal to the synchronous path's within {SEARCH_SCORE_TOL} (tie runs as sets)")


def _tpx_profile(seed, shard_counts, out, launches) -> None:
    """(e) on each of ``shard_counts``, in one child process of this
    script (``--tpx-profile-shards 1,2``): a profiler session there starts
    from a fresh CUPTI state, where after this process's earlier sessions
    whole captures came back without their kernels. One child for every
    shard count draws the weights once (one a count before phase 20). Its
    log lines are relayed, its launches counted here; a child that fails
    fails the phase."""
    arg = ",".join(str(n) for n in shard_counts)
    cmd = [sys.executable, os.path.abspath(__file__), "--tpx-profile-shards", arg,
           "--seed", str(seed)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TPX_PROFILE_CHILD_S)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"tpx (e) TP={arg}: the profile process exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    got = json.loads(lines[-1])
    out.update(got["profile"])
    launches.update(got["launches"])


def tpx_profile_child(dev, seed, shard_counts) -> dict:
    """The child's side of :func:`_tpx_profile`: recipe A's weights from
    ``seed``, :func:`_tpx_profile_here` on each shard count in turn, and
    their readings and launches."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    params = quant.init_packed_params_int8(llama.PRESETS[_cut_model(TPX_PROFILE_LAYERS)], seed,
                                           torch.bfloat16, dev)
    out, launches = {}, collections.Counter()
    for shards in shard_counts:
        _tpx_profile_here(dev, params, shards, out, launches)
        gc.collect()
        torch.cuda.empty_cache()
    return {"profile": out, "launches": dict(launches)}


def _tpx_profile_here(dev, params, shards, out, launches) -> None:
    """(e) the port's profile_decode on recipe A at TPX_PROFILE_LAYERS, B = 8:
    steady decode and one 512-bucket prefill, each window complete (up to
    TPX_PROFILE_TRIES captures), split by JAX's categories."""
    from generativeaiexamples_tpu_torch.tools import profile_decode

    cfg = dataclasses.replace(_tpx_config("A", _cut_model(TPX_PROFILE_LAYERS)),
                              max_batch_size=TPX_PROFILE_BATCH, max_seq_len=TPX_PROFILE_SEQ)
    saved = os.environ.get("ENABLE_PROFILING")
    os.environ["ENABLE_PROFILING"] = "true"  # the engine's labels, the reduce's among them
    try:
        engine = _tpx_engine(cfg, params, dev, shards)
    finally:
        if saved is None:
            os.environ.pop("ENABLE_PROFILING", None)
        else:
            os.environ["ENABLE_PROFILING"] = saved
    res = {}
    try:
        for window in ("decode", "prefill"):
            for attempt in range(1, TPX_PROFILE_TRIES + 1):
                reset_counts()
                if window == "decode":
                    rep = profile_decode.profile_decode(engine, TPX_PROFILE_SECONDS,
                                                        TPX_PROFILE_PROMPT)
                else:
                    rep = profile_decode.profile_prefill(engine, TPX_PREFILL_IDS)
                launches.update(counts())
                _settle(engine)
                if rep["complete"] and rep["busy_ms"] is not None:
                    break
                seen = {k: rep.get(k) for k in ("kernels_in_trace", "kernels_launched",
                                                 "device_events", "wall_ms")}
                log(f"    tpx (e) TP={shards} {window}: capture {attempt} not measured "
                    f"({rep['not_measured']}: {seen}, {threading.active_count()} threads); "
                    f"again")
            else:
                raise AssertionError(f"tpx (e) TP={shards} {window}: no complete trace in "
                                     f"{TPX_PROFILE_TRIES} captures")
            rep["captures"] = attempt
            cats = rep["categories_ms"]
            if (cats["collective"] > 0) != (shards > 1):
                raise AssertionError(f"tpx (e) TP={shards} {window}: collective "
                                     f"{cats['collective']:.4f} ms")
            buf = []

            class _Lines:
                def write(self, text):
                    buf.append(text)

            profile_decode.print_report(rep, out=_Lines())
            for line in "".join(buf).splitlines():
                log(f"    {line}")
            res[window] = {k: rep[k] for k in ("wall_ms", "busy_ms", "idle_ms", "idle_share",
                                               "categories_ms", "kernels_ms", "captures")}
            if window == "decode":
                res[window]["decode_steps"] = rep["decode_steps"]
    finally:
        engine.shutdown()
        _free_engine(engine)
    out[f"TP{shards}"] = res


def phase_tpx(dev, smi, seed=0) -> dict:
    """The paths served across shards (module docstring, phase 18)."""
    import random

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    t0 = time.time()
    rng = random.Random(seed * 1000 + 18)
    out = {"spec": {}, "drain": {}, "profile": {}}
    launches = collections.Counter()
    params = quant.init_packed_params_int8(llama.PRESETS[MODEL], seed, torch.bfloat16, dev)
    model8 = _cut_model(TPX_LAYERS)
    params8 = dict(params, layers=params["layers"][:TPX_LAYERS])
    spool = tempfile.mkdtemp(prefix="tpx_spool_")
    try:
        # (a) spec on shards: A (lookup, the 1b-proxy draft), D (lookup)
        prompts = [_spec_prompt("copy_heavy", r) for r in range(TPX_SPEC_REQUESTS)]
        for name in TPX_SPEC_LEGS:
            _tpx_spec(dev, name, _tpx_config(name, model8, spec_draft_model=SPEC_DRAFT_MODEL
                                             if name == "A" else ""),
                      params8, prompts, out["spec"], launches)
            gc.collect()
            torch.cuda.empty_cache()
        t_a = time.time()
        # (b) drain/restore on shards: A (bf16 pool) and C (int4 pool)
        for name in TPX_DRAIN_RECIPES:
            _tpx_drain(dev, name, _tpx_config(name, model8, snapshot_spool_dir=spool), params8,
                       rng, out["drain"], launches)
            gc.collect()
            torch.cuda.empty_cache()
        t_b = time.time()
        # (c) disagg, (d) the retrieval tier beside the TP=2 engine
        cfg_a = _tpx_config("A", model8)
        _tpx_disagg(dev, cfg_a, params8, rng, out, launches)
        _tpx_tier(dev, cfg_a, params8, rng, out, seed)
        gc.collect()
        torch.cuda.empty_cache()
        t_d = time.time()
        del params, params8
        gc.collect()
        torch.cuda.empty_cache()
        # (e) the decode profiler at TPX_PROFILE_LAYERS, TP=1 then TP=2, in a
        # process of its own
        _tpx_profile(seed, (1, TPX_SHARDS), out["profile"], launches)
    finally:
        shutil.rmtree(spool, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["wall_s"] = time.time() - t0
    out["walls_s"] = {"spec": t_a - t0, "drain": t_b - t_a, "disagg_tier": t_d - t_b,
                      "profile": time.time() - t_d}
    log(f"  tpx launches in the phase (every shard's): {dict(launches)}; walls "
        f"{ {k: round(v, 1) for k, v in out['walls_s'].items()} }")
    if out["wall_s"] > TPX_BUDGET_S:
        log(f"  tpx: the phase took {out['wall_s']:.1f} s, over its {TPX_BUDGET_S:.0f} s budget")
    log(f"phase tpx: ok ({out['wall_s']:.1f} s on {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 19: pipeline-parallel serving and the ANN shard merge

PP_MAX_SEQ = 2048
PP_PREFILL_IDS = 512  # the model functions' prefill, then PP_DECODE_STEPS steps
PP_DECODE_STEPS = 8
PP_TOKENS = 32  # each served stream, greedy
PP_LAYERS_70B = 4  # (d): 2 a stage
PP_CKPT_LAYERS = 4  # (e)
PP_SEARCH_ROWS = 65536  # (f): phase 6's store
PP_SEARCH_DIM = 1024
PP_SEARCH_SHARDS = 2
PP_SEARCH_QUERIES = 8
PP_SEARCH_TOL = 1e-5
PP_BUDGET_S = 100.0
# the largest |logits difference| between a PP engine's model functions and
# its reference's, teacher-forced along the reference's greedy tokens. The
# walk adds no rounding of its own: where each stage has the reference's
# shard count it is the reference's function bit for bit and is held to 0;
# PP=2 x TP=2 against TP=1 keeps phase 16's limit of recipe D
PP_TP_LOGITS_LIMIT = TP_LOGITS_LIMITS["8b D"]
_PP_PAGED = tuple(name for name in KERNELS if name.startswith("paged_attention"))


def _pp_model_run(engine, prompt, forced=None) -> tuple:
    """The engine's model functions on one prompt of its own cache: the
    prefill's logits, then PP_DECODE_STEPS decode steps fed ``forced`` (the
    reference's tokens) or, without it, the run's own greedy tokens.
    Returns (logits a step, the tokens fed)."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel import pp_serving

    cfg, dev = engine.model_config, engine.device
    ids = torch.tensor([prompt], device=dev)
    n = torch.tensor([len(prompt)], device=dev)
    slot = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        if engine._pp is not None:
            cache = pp_serving.init_cache(cfg, engine._pp, 1, PP_MAX_SEQ, torch.bfloat16,
                                          quantized=engine._kv_quant)
            logits, _ = pp_serving.build_prefill(cfg, engine._pp)(engine.params, cache, ids, n,
                                                                  slot)
            decode = pp_serving.build_decode_step(cfg, engine._pp, kv_kernel=engine._kv_kernel)

            def step(tok, pos):
                return decode(engine.params, cache, tok, pos)[0]
        else:
            cache = llama.init_kv_cache_layers(cfg, 1, PP_MAX_SEQ, torch.bfloat16, dev,
                                               quantized=engine._kv_quant, tp=engine._tp)
            logits, kvs = llama.prefill_layers(engine.params, cfg, ids, n,
                                               quant_kernel=engine._quant_kernel, tp=engine._tp)
            llama.write_prefill_slots(cache, kvs, slot, tp=engine._tp)
            del kvs

            def step(tok, pos):
                return llama.decode_layers(engine.params, cfg, tok, pos, cache,
                                           quant_kernel=engine._quant_kernel,
                                           kv_kernel=engine._kv_kernel, tp=engine._tp)[0]
        out, fed = [logits[0].float()], []
        for i in range(PP_DECODE_STEPS):
            tok = forced[i] if forced is not None else int(
                torch.argmax(out[-1][: engine._sample_vocab]))
            fed.append(tok)
            pos = torch.tensor([len(prompt) + i], device=dev)
            out.append(step(torch.tensor([tok], device=dev), pos)[0].float())
    return out, fed


def _pp_logits_check(ref_logits, logits, vocab, label) -> tuple:
    """(largest |difference| over the steps, steps whose greedy token
    parts from the reference's at a tie): a part where the reference's
    top-1 margin exceeds LOGITS_TOL fails."""
    diff, ties = 0.0, 0
    for i, (a, b) in enumerate(zip(ref_logits, logits)):
        diff = max(diff, _max_err(a, b))
        if int(torch.argmax(a[:vocab])) != int(torch.argmax(b[:vocab])):
            top2 = torch.topk(a[:vocab], 2).values
            margin = float(top2[0] - top2[1])
            if margin > LOGITS_TOL:
                raise AssertionError(f"pp {label}: step {i}'s greedy token parts from the "
                                     f"reference's beyond a tie (margin {margin:.4g})")
            ties += 1
    return diff, ties


def _pp_http(engine) -> list:
    """The OpenAI-compatible engine server in process over ``engine``:
    TP_SERVER_REQUESTS greedy chat completions; their texts."""
    from generativeaiexamples_tpu_torch.engine.server import make_server

    server = make_server("127.0.0.1", 0, engine=engine)
    threading.Thread(target=server.serve_forever, name="smoke-http-pp", daemon=True).start()
    try:
        return _tp_answers(f"http://127.0.0.1:{server.server_address[1]}")
    finally:
        server.shutdown()
        server.server_close()


def _pp_engine(cfg, params, dev, stages, tp, cards=False):
    """An engine of ``stages`` x ``tp`` shards, every one on ``dev``, or
    with ``cards`` each on a card of its own (cuda:0, cuda:1, ...)."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.parallel import create_mesh

    if stages * tp == 1:
        return LLMEngine(cfg, device=dev, params=params)
    devices = ([torch.device("cuda", i) for i in range(stages * tp)] if cards
               else [dev] * (stages * tp))
    return LLMEngine(dataclasses.replace(cfg, tensor_parallelism=tp, pipeline_parallelism=stages),
                     params=params, mesh=create_mesh(tp, pipeline_parallelism=stages, devices=devices))


def pp_leg(dev, label, model, quantization, kv_dtype, params, ref_tp, layouts, prompts, probe,
           expected, http=(), cards=False) -> tuple:
    """One leg: a reference engine (one stage of ``ref_tp`` shards) and
    then each (stages, tp) of ``layouts`` on the same single-device tree,
    built one after another, every shard on ``dev`` (with ``cards``, each
    PP engine's shards on cards of their own). Each PP engine's model
    functions on ``probe`` (a prefill and PP_DECODE_STEPS steps fed the
    reference's greedy tokens) equal the reference's bit for bit where each
    stage has ``ref_tp`` shards, and stay within PP_TP_LOGITS_LIMIT of
    them where it has not;
    its served streams (``prompts`` as one wave x PP_TOKENS, greedy, and
    for the layouts in ``http`` TP_SERVER_REQUESTS chat completions behind
    the engine server) equal the reference's but at ties; its path
    launches every kernel of ``expected`` and no paged_attention. Returns
    (numbers, launches of the PP engines' serving)."""
    base = EngineConfig(model_config_name=model, quantization=quantization, kv_cache_dtype=kv_dtype,
                        kv_layout="fixed", max_seq_len=PP_MAX_SEQ, tensor_parallelism=ref_tp)
    t0 = time.time()
    ref = _pp_engine(base, params, dev, 1, ref_tp)
    try:
        ref_logits, forced = _pp_model_run(ref, probe)
        want, wall_ref = _tp_streams(ref, prompts, PP_TOKENS)
        want_http = _pp_http(ref) if http else None
    finally:
        ref.shutdown()
    ref._cache = ref._prefix_store = None  # its weights stay for the tie checks
    out = {"reference": f"TP={ref_tp}", "wall_block_ms_ref": wall_ref, "layouts": {}}
    launches = collections.Counter()
    try:
        for stages, tp in layouts:
            name = f"PP={stages}xTP={tp}"
            limit = 0.0 if tp == ref_tp else PP_TP_LOGITS_LIMIT
            t1 = time.time()
            engine = _pp_engine(base, params, dev, stages, tp, cards)
            try:
                if engine._pp is None or (engine._pp.stages, engine.tp_shards) != (stages, tp):
                    raise AssertionError(f"pp {label}: {name} is not the engine asked for")
                logits, _ = _pp_model_run(engine, probe, forced)
                reset_counts()
                with SyncCounter() as syncs:
                    got, wall = _tp_streams(engine, prompts, PP_TOKENS)
                    got_http = _pp_http(engine) if (stages, tp) in http else None
                launched = counts()
            finally:
                engine.shutdown()
                _free_engine(engine)
            diff, step_ties = _pp_logits_check(ref_logits, logits, ref._sample_vocab, f"{label} {name}")
            ties = sum(_tie_checked(ref, f"pp {label} {name} prompt {i}", p, g, w)
                       for i, (p, g, w) in enumerate(zip(prompts, got, want)))
            if got_http is not None and got_http != want_http:
                raise AssertionError(f"pp {label} {name}: the server answered {got_http!r}, the "
                                     f"reference {want_http!r}")
            if not diff <= limit:
                raise AssertionError(f"pp {label} {name}: the largest logits difference "
                                     f"{diff:.4g} against TP={ref_tp} exceeds its limit {limit}")
            missing = [k for k in expected if launched[k] == 0]
            paged = {k: launched[k] for k in _PP_PAGED if launched[k]}
            if missing or paged:
                raise AssertionError(f"pp {label} {name}: kernels never launched {missing}, "
                                     f"paged_attention launched {paged}")
            if syncs.counts["torch-llm-engine"]:
                raise AssertionError(f"pp {label} {name}: the dispatch thread waited for the card "
                                     f"{syncs.counts['torch-llm-engine']} times")
            launches.update(launched)
            out["layouts"][name] = {"max_logits_diff": diff, "logits_ties": step_ties,
                                    "stream_ties": ties, "wall_block_ms": wall,
                                    "launches": dict(launched), "wall_s": time.time() - t1}
            http_note = (f"; {TP_SERVER_REQUESTS} chat completions behind the engine server equal "
                         f"the reference's" if got_http is not None else "")
            log(f"  pp {label} {name}: {model} {quantization}/{kv_dtype} fixed; {PP_PREFILL_IDS}-id "
                f"prefill + {PP_DECODE_STEPS} steps against TP={ref_tp}: largest logits difference "
                f"{diff:.4g} (limit {limit}, {step_ties} greedy ties); {len(prompts)} greedy prompts "
                f"of {min(map(len, prompts))}-{max(map(len, prompts))} ids x {PP_TOKENS} tokens "
                f"equal TP={ref_tp}'s ({ties} parted at a tie){http_note}; decode block wall "
                f"{wall:.2f} ms against {wall_ref:.2f} ms at TP={ref_tp} ({wall / wall_ref:.2f}x); "
                f"launches {dict(launched)}; {time.time() - t1:.1f} s")
    finally:
        _free_engine(ref)
    out["wall_s"] = time.time() - t0
    return out, launches


def _pp_checkpoint(dev, seed, tmp) -> dict:
    """(e) a llama3-8b-width checkpoint of PP_CKPT_LAYERS layers streamed
    into PP=2 x TP=2 on ``dev``: every pack and tensor byte-equal to the
    layered load's (per-shard packs at TP=2) cut into the stages."""
    from generativeaiexamples_tpu_torch.models import hf_loader, llama
    from generativeaiexamples_tpu_torch.parallel import create_mesh, pp_serving

    cfg = dataclasses.replace(llama.PRESETS[MODEL], num_layers=PP_CKPT_LAYERS)
    path = os.path.join(tmp, "pp_ckpt")
    t0 = time.time()
    hf_loader.write_hf_checkpoint(cfg, path, seed=seed, n_shards=2, dtype=torch.bfloat16, device=dev)
    t_write = time.time() - t0
    ctx = pp_serving.PPContext(create_mesh(2, pipeline_parallelism=2, devices=[dev] * 4), 2, 2)
    stats = {}
    try:
        torch.cuda.synchronize(dev)
        t1 = time.time()
        got = hf_loader.load_params_pp_streaming(path, cfg, torch.bfloat16, quantization="int8",
                                                 ctx=ctx, stats=stats)
        torch.cuda.synchronize(dev)
        seconds = time.time() - t1
        want = pp_serving.stage_params(hf_loader.load_params_layered_streaming(
            path, cfg, torch.bfloat16, quantization="int8", tp_shards=2, device=dev), ctx)
        leaves = 0
        for key in ("embed", "final_norm", "lm_head", "layers"):
            a, b = got[key], want[key]
            if not _same_tree(a, b):
                raise AssertionError(f"pp (e): the streamed {key} is not the layered load's")
            leaves += sum(1 for _ in _tree_leaves(a))
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    del got, want
    log(f"  pp (e): a {nbytes / 1e9:.2f} GB bf16 checkpoint of {PP_CKPT_LAYERS} layers at {MODEL} "
        f"width (written in {t_write:.1f} s) streamed into PP=2 x TP=2 in {seconds:.2f} s, "
        f"peak_host_bytes {stats['peak_host_bytes'] / 1e9:.3f} GB; {leaves} tensors byte-equal "
        f"to the layered load's per-shard packs cut into the stages (warm page cache)")
    return {"seconds": seconds, "peak_host_bytes": stats["peak_host_bytes"], "bytes": nbytes,
            "tensors": leaves}


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def _pp_search(dev, seed, timer, smi) -> dict:
    """(f) item 9d: a PP_SEARCH_ROWS x PP_SEARCH_DIM store of random unit
    rows, exact and IVF (nlist 64, nprobe 16), on one shard against
    PP_SEARCH_SHARDS shards on ``dev``: PP_SEARCH_QUERIES queries at k 4
    and 16, indices equal but at ties, scores within PP_SEARCH_TOL; the
    device time of a search on each."""
    from generativeaiexamples_tpu_torch.parallel import create_mesh
    from generativeaiexamples_tpu_torch.retrieval.ann import ANNSearchEngine, k_rung

    rng = np.random.default_rng(seed * 1000 + 19)
    corpus = rng.standard_normal((PP_SEARCH_ROWS, PP_SEARCH_DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((PP_SEARCH_QUERIES, PP_SEARCH_DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    q_dev = torch.from_numpy(queries).to(dev)
    out = {}
    for mode in ("exact", "ivf"):
        engines = {}
        for shards in (1, PP_SEARCH_SHARDS):
            kw = (dict(device=dev) if shards == 1
                  else dict(mesh=create_mesh(shards, devices=[dev] * shards)))
            eng = ANNSearchEngine(PP_SEARCH_DIM, mode=mode, nlist=64, nprobe=16, **kw)
            eng.refresh(corpus, version=1)
            if eng.describe()["shards"] != shards:
                raise AssertionError(f"pp (f) {mode}: {eng.describe()['shards']} shards, not {shards}")
            engines[shards] = eng
        for k in (4, 16):
            one_s, one_i = engines[1].search(queries, k)
            two_s, two_i = engines[PP_SEARCH_SHARDS].search(queries, k)
            _check_topk(two_s, two_i, one_s, one_i, PP_SEARCH_TOL, f"pp (f) {mode} k {k}")
            ms = {}
            for shards, eng in engines.items():
                corp = eng._corpus
                nprobe = min(16, corp.centroids.shape[0]) if mode == "ivf" else 0
                kr = k_rung(k, corp.capacity)
                with torch.inference_mode():
                    ms[shards] = timer.ms(lambda: eng._topk(corp, q_dev, kr, nprobe))
            out[f"{mode}_k{k}"] = {"ms_1_shard": ms[1], f"ms_{PP_SEARCH_SHARDS}_shards":
                                   ms[PP_SEARCH_SHARDS],
                                   "max_score_diff": float(np.abs(two_s - one_s).max())}
            log(f"  pp (f) search[{mode}] {PP_SEARCH_QUERIES} queries k {k}: {PP_SEARCH_SHARDS} "
                f"shards equal one (scores within {float(np.abs(two_s - one_s).max()):.3g}, limit "
                f"{PP_SEARCH_TOL}); {ms[1]:.4f} ms on one shard, {ms[PP_SEARCH_SHARDS]:.4f} ms on "
                f"{PP_SEARCH_SHARDS} (one card) on {smi}")
        del engines
    return out


def phase_pp(dev, smi, seed=0, scratch=None) -> dict:
    """Pipeline-parallel serving and the ANN shard merge (module docstring,
    phase 19)."""
    import random

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    t0 = time.time()
    rng = random.Random(seed * 1000 + 19)
    out = {"legs": {}}
    launches = collections.Counter()
    timer = Timer(dev)
    probe = _tp_prompts(rng, [PP_PREFILL_IDS])[0]
    # (a)-(c) at CUT_LAYERS since phase 21 (at full depth before)
    model = _cut_model(CUT_LAYERS)
    params = quant.init_packed_params_int8(llama.PRESETS[model], seed, torch.bfloat16, dev)
    d_expected = ("int8_matmul", "flash_attention_causal", "decode_attention")
    try:
        # (a) recipe D: PP=2, then PP=2 x TP=2, against TP=1
        prompts = _tp_prompts(rng, TP_LENGTHS_8B)
        res, got = pp_leg(dev, "(a) D", model, "int8", "int8", params, 1, ((2, 1), (2, 2)),
                          prompts, probe, d_expected, http=((2, 1),))
        out["legs"]["a_D"] = res
        launches.update(got)
        # (b) w8a8 over int8 strips and (c) int8 weights over bf16 strips,
        # PP=2, on (a)'s prompts
        for leg, quantization, kv_dtype, expected in (
                ("(b) w8a8", "w8a8", "int8",
                 ("int8_w8a8_matmul", "flash_attention_causal", "decode_attention")),
                ("(c) bf16 strips", "int8", "bfloat16", ("int8_matmul", "flash_attention_causal"))):
            res, got = pp_leg(dev, leg, model, quantization, kv_dtype, params, 1, ((2, 1),),
                              prompts, probe, expected)
            out["legs"][leg.split()[0].strip("()") + "_" + quantization + "_" + kv_dtype] = res
            launches.update(got)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # (d) llama3-70b's width, PP=2 x TP=8 (16 shards on the card) against TP=8
        model70 = f"{TP_MODEL_70B}-{PP_LAYERS_70B}-layers"
        llama.PRESETS[model70] = dataclasses.replace(llama.PRESETS[TP_MODEL_70B],
                                                     num_layers=PP_LAYERS_70B)
        params70 = quant.init_packed_params_int8(llama.PRESETS[model70], seed, torch.bfloat16, dev)
        res, got = pp_leg(dev, "(d) 70b", model70, "int8", "int8", params70, TP_SHARDS_70B,
                          ((2, TP_SHARDS_70B),), _tp_prompts(rng, TP_LENGTHS_70B), probe,
                          d_expected)
        out["legs"]["d_70b"] = res
        launches.update(got)
        del params70
        gc.collect()
        torch.cuda.empty_cache()
        t_d = time.time()
        out["checkpoint"] = _pp_checkpoint(dev, seed, scratch or tempfile.gettempdir())
        gc.collect()
        torch.cuda.empty_cache()
        t_e = time.time()
        out["search"] = _pp_search(dev, seed, timer, smi)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(launches)
    out["wall_s"] = time.time() - t0
    out["walls_s"] = {k: round(v["wall_s"], 1) for k, v in out["legs"].items()}
    out["walls_s"].update(checkpoint=round(t_e - t_d, 1), search=round(time.time() - t_e, 1))
    log(f"  pp launches in the phase's serving (every stage's shards): {dict(launches)}; walls "
        f"{out['walls_s']}")
    if out["wall_s"] > PP_BUDGET_S:
        log(f"  pp: the phase took {out['wall_s']:.1f} s, over its {PP_BUDGET_S:.0f} s budget")
    log(f"phase pp: ok ({out['wall_s']:.1f} s on {smi})")
    return out


PPCARDS_LAYOUTS = ((2, 1), (2, 2))


def phase_ppcards(dev, smi, seed=0) -> dict:
    """Phase 19's leg (a) with every stage and shard on a card of its own
    (``--phases ppcards``, on 4 cards; not in the default run): llama3-8b
    at full width and depth, int8 weights over int8 strips, TP=1 on the
    first card against PP=2 over two cards and PP=2 x TP=2 over four. Each
    stage's kernels launch on its own card (pp_serving's stage scope): the
    PP=2 logits equal TP=1's bit for bit, PP=2 x TP=2's stay within
    PP_TP_LOGITS_LIMIT, the streams equal TP=1's but at ties, and the
    decode block walls are printed."""
    import random

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    need = max(stages * tp for stages, tp in PPCARDS_LAYOUTS)
    if torch.cuda.device_count() < need:
        raise RuntimeError(f"ppcards: {need} cards wanted, {torch.cuda.device_count()} visible")
    t0 = time.time()
    rng = random.Random(seed * 1000 + 20)
    probe = _tp_prompts(rng, [PP_PREFILL_IDS])[0]
    params = quant.init_packed_params_int8(llama.PRESETS[MODEL], seed, torch.bfloat16, dev)
    try:
        res, launches = pp_leg(dev, "cards D", MODEL, "int8", "int8", params, 1, PPCARDS_LAYOUTS,
                               _tp_prompts(rng, TP_LENGTHS_8B), probe,
                               ("int8_matmul", "flash_attention_causal", "decode_attention"),
                               cards=True)
    finally:
        del params
        gc.collect()
        for i in range(need):
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
    out = {"legs": {"a_D": res}, "launches": dict(launches), "wall_s": time.time() - t0}
    log(f"phase ppcards: ok ({out['wall_s']:.1f} s on {need} x {smi})")
    return out


# --------------------------------------------------------------------- #
# Phase 20: many processes, ring attention and sharded training

MULTI_RING = dict(B=1, T=8192, Hq=32, Hkv=8, Dh=128)  # llama3-8b's attention widths
MULTI_RING_SHARDS = 4
MULTI_MESH = (2, 2, 2)  # (b): tp, dp, sp, every device cuda:0
MULTI_BATCH = (4, 1024)  # (b): B x T
MULTI_LAYERS = CUT_LAYERS  # (b), since phase 21 (llama3-8b's full depth before)
MULTI_CLI_LAYERS = 8  # (c): 8 of llama3-8b's 32 layers
MULTI_CLI_STEPS = 3
MULTI_CLI_BATCH = (2, 512)  # (c): --batch-size, --seq-len
# (b): B starts at N(0, MULTI_B_STD^2) (not zero, so the forward runs the
# adapters and A's gradient, through the row-parallel A cut and its reduce,
# is not zero); two steps
MULTI_B_STD = 0.01
# (b): each step's loss against the one-device step's: they differ only by
# the bf16 rounding of each row-parallel partial and the shards'
# summation order
MULTI_LOSS_RTOL = 1e-3
# (b): the share of adapter elements (A and B) whose two-step update took
# the other sign than the one-device step's. Each AdamW step moves an
# element by about lr * sign(g), so an element whose gradient is near 0
# can flip when those roundings move it. Set from the card's reading
# (NVIDIA H100 80GB HBM3, 700 W: the clean steps 0.70 %, the planted
# fault of (b), one data replica's rows dropped, 26.6 %; 5 % lies near
# their geometric mean, 4.3 %); the phase fails if the planted fault does
# not exceed it
MULTI_SIGN_FLIPS = 0.05
MULTI_BUDGET_S = 90.0
MULTICARDS_PROCS = (2, 4)
# multicards: (b) in one process with each shard on a card of its own, tp
# 2 x dp 2 over cuda:0-3 (the base placed on the second replica's cards
# once, kept over the steps)
MULTICARDS_MESH = (2, 2, 1)
MULTI_LAUNCH_DEVICE = "cuda"  # (c): each launched process's --device (its card: cuda:(i % cards))


def _multi_ring(dev) -> dict:
    """(a) ring_attention over 4 seq shards of this card against
    reference_attention, at llama3-8b's attention widths, bf16 in."""
    from generativeaiexamples_tpu_torch.parallel import create_mesh, reference_attention, ring_attention

    c = MULTI_RING
    gen = torch.Generator(device=dev).manual_seed(20)
    q = torch.randn(c["B"], c["T"], c["Hq"], c["Dh"], generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(c["B"], c["T"], c["Hkv"], c["Dh"], generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    mesh = create_mesh(1, 1, MULTI_RING_SHARDS, devices=[dev] * MULTI_RING_SHARDS)
    walls = {}
    for name, fn in (("ring", lambda: ring_attention(q, k, v, mesh)),
                     ("reference", lambda: reference_attention(q, k, v))):
        fn()  # warm
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        walls[name] = 1e3 * (time.perf_counter() - t1)
        if name == "ring":
            got = out
        else:
            ref = out
        del out
    err = float((got.float() - ref.float()).abs().max())
    limit = float(ref.float().abs().max()) * 2 ** -7  # one bf16 ulp of the largest output
    del q, k, v, got, ref
    torch.cuda.empty_cache()
    if not err <= limit:
        raise AssertionError(f"multi (a): ring max |err| {err!r} over its limit {limit!r}")
    log(f"  multi (a): ring_attention B={c['B']} T={c['T']} Hq={c['Hq']} Hkv={c['Hkv']} Dh={c['Dh']} "
        f"bf16 over {MULTI_RING_SHARDS} seq shards of {dev}: max |err| {err:.3g} against "
        f"reference_attention (limit {limit:.3g}, one bf16 ulp of the largest output); wall ring "
        f"{walls['ring']:.2f} ms, reference {walls['reference']:.2f} ms")
    return {"max_abs_err": err, "limit": limit, "ring_ms": walls["ring"],
            "reference_ms": walls["reference"]}


def _flat(tree, suffix) -> torch.Tensor:
    """Every adapter factor ending in ``suffix`` (``_a``, ``_b``) of an
    adapter tree, whole and flat, f32."""
    return torch.cat([lp[k].detach().float().reshape(-1) for lp in tree for k in sorted(lp)
                      if k.endswith(suffix)])


def _multi_sharded_lora(dev, seed, shape=MULTI_MESH, devices=None) -> dict:
    """(b) two LoRA steps at llama3-8b's full width, MULTI_LAYERS deep, on tp x dp
    x sp ``shape`` (every shard on this card, or on ``devices``) against
    the one-device steps on ``dev``; then the planted fault: the
    one-device steps on data replica 0's rows alone (a replica whose
    gradients were never summed in), which the sign-flip limit must
    catch."""
    import random

    from generativeaiexamples_tpu_torch.models import llama, lora, train
    from generativeaiexamples_tpu_torch.parallel import create_mesh, sharding

    cfg = llama.PRESETS[_cut_model(MULTI_LAYERS)]
    lcfg = lora.LoRAConfig(**TRAIN_LORA)
    optimizer = train.make_optimizer(learning_rate=TRAIN_LORA_LR)
    rng = random.Random(seed * 1000 + 20)
    B, T = MULTI_BATCH
    tokens = torch.tensor([[rng.randrange(1, 256) for _ in range(T)] for _ in range(B)])
    mask = torch.ones((B, T))
    mask[:, : T // 8] = 0.0
    batch = {"tokens": tokens.to(dev), "loss_mask": mask.to(dev)}
    base = llama.init_params(cfg, seed, torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    adapters = [{k: v if k.endswith("_a") else
                 (torch.randn(v.shape, generator=gen, device=dev) * MULTI_B_STD).to(v.dtype)
                 for k, v in lp.items()}
                for lp in lora.init_lora_params(cfg, lcfg, gen, torch.bfloat16, dev)]
    start = {s: _flat(adapters, s) for s in ("_a", "_b")}

    def state(ad):
        ad = train.trainable(ad)
        return train.TrainState(params=ad, opt_state=optimizer.init(ad),
                                step=torch.zeros((), dtype=torch.int32, device=dev))

    def timed(fn):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, 1e3 * (time.perf_counter() - t1)

    def two_steps(step, st, base_, batch_, whole=lambda p: p):
        """Two steps from ``st``: the state, their losses, the updates of
        A and B (flat, ``whole``) and each step's wall."""
        (st, l1), ms1 = timed(lambda: step(st, base_, batch_))
        (st, l2), ms2 = timed(lambda: step(st, base_, batch_))
        moved = {s: _flat(whole(st.params), s) - start[s] for s in ("_a", "_b")}
        return st, [float(l1), float(l2)], moved, [ms1, ms2]

    one_step = train.make_lora_train_step(cfg, lcfg, optimizer)
    _, one_losses, want, one_ms = two_steps(one_step, state(adapters), base, batch)
    half = {k: v[: B // shape[1]] for k, v in batch.items()}
    _, fault_losses, fault, _ = two_steps(one_step, state(adapters), base, half)
    devices = devices or [dev] * (shape[0] * shape[1] * shape[2])
    mesh = create_mesh(*shape, devices=devices)
    held = _peak_reset(dev)
    sbase = sharding.shard_params(base, mesh)
    sad = lora.shard_lora_params(adapters, lcfg, mesh)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    step = train.make_lora_train_step(cfg, lcfg, optimizer, shape[2] > 1, mesh)
    got_state, losses, got, ms = two_steps(step, state(sad), sbase, batch,
                                           lambda p: sharding.unshard(p, dev))
    trace = _traced(lambda: step(got_state, sbase, batch))
    peak = torch.cuda.max_memory_allocated(dev)
    del got_state, sbase, sad
    gc.collect()
    torch.cuda.empty_cache()

    def flips(a, b) -> dict:
        per = {s: float((torch.sign(a[s]) != torch.sign(b[s])).float().mean()) for s in a}
        n = {s: a[s].numel() for s in a}
        per["all"] = sum(per[s] * n[s] for s in n) / sum(n.values())
        return per

    rels = [abs(l - w) / abs(w) for l, w in zip(losses, one_losses)]
    clean, planted = flips(got, want), flips(got, fault)
    if not max(rels) <= MULTI_LOSS_RTOL:
        raise AssertionError(f"multi (b): sharded losses {losses!r} against one device's "
                             f"{one_losses!r}: {max(rels):.3g} relative, over {MULTI_LOSS_RTOL}")
    if not clean["all"] <= MULTI_SIGN_FLIPS:
        raise AssertionError(f"multi (b): the updated adapters part from the one-device steps': "
                             f"{clean} of their elements moved the other way (limit {MULTI_SIGN_FLIPS})")
    if not planted["all"] > MULTI_SIGN_FLIPS:
        raise AssertionError(f"multi (b): the planted fault (data replica 0's rows alone) moved only "
                             f"{planted} of the elements the other way: the limit {MULTI_SIGN_FLIPS} "
                             f"cannot see a replica left out")
    log(f"  multi (b): two LoRA steps (r={lcfg.rank} on {','.join(lcfg.targets)}, B from "
        f"N(0, {MULTI_B_STD}^2)) at llama3-8b full width, {MULTI_LAYERS} of 32 layers, bf16, "
        f"B={B} T={T}, tp "
        f"{shape[0]} x dp {shape[1]} x sp {shape[2]} on {[str(d) for d in devices]}: losses "
        f"{[round(l, 6) for l in losses]} against one device's {[round(l, 6) for l in one_losses]} "
        f"({max(rels):.2e} relative at most, limit {MULTI_LOSS_RTOL}); the updates' signs against "
        f"one device's: {clean['all']:.4f} of {sum(t.numel() for t in got.values())} elements "
        f"flipped (A {clean['_a']:.4f}, B {clean['_b']:.4f}; limit {MULTI_SIGN_FLIPS}); the planted "
        f"fault (one device on replica 0's rows alone, losses "
        f"{[round(l, 6) for l in fault_losses]}): {planted['all']:.4f} (A {planted['_a']:.4f}, "
        f"B {planted['_b']:.4f}); wall a step {ms[1]:.1f} ms (first {ms[0]:.1f}; one device "
        f"{one_ms[1]:.1f} ms, first {one_ms[0]:.1f}); a traced step: wall {trace['wall_ms']:.1f} ms, "
        f"device busy {trace['busy_ms']} ms, idle share {trace['idle_share']}, "
        f"{trace.get('events')} device events, the most device time {trace['top']}; peak allocated "
        f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} held before)")
    return {"mesh": list(shape), "devices": [str(d) for d in devices],
            "losses": losses, "one_device_losses": one_losses, "loss_rel": max(rels),
            "sign_flips": clean, "planted_fault_sign_flips": planted,
            "planted_fault_losses": fault_losses, "step_ms": ms[1], "first_step_ms": ms[0],
            "one_device_ms": one_ms[1], "traced_step": trace, "peak_allocated_bytes": peak}


def _parallel_lines(stderr: str) -> list:
    return [json.loads(line[len("parallel: "):]) for line in stderr.splitlines()
            if line.startswith("parallel: ")]


def _multi_cli(tmp, nproc, device) -> dict:
    """The finetune CLI in LoRA mode at llama3-8b's width and
    MULTI_CLI_LAYERS layers (a checkpoint of random weights), ``--dp
    nproc``, each data replica MULTI_CLI_BATCH's rows: under
    tools/launch.py in ``nproc`` processes (``device`` None, ``--device
    cuda``: process i on cuda:(i % cards)), or in this process on
    ``device`` repeated. Returns its last line, the ``parallel:`` lines,
    the checkpointed adapters and the wall."""
    data = os.path.join(tmp, "data.jsonl")
    if not os.path.exists(data):
        with open(data, "w", encoding="utf-8") as fh:
            for i in range(16):
                fh.write(json.dumps({"text": f"passage {i}: " + "the card tiles ride the tensor "
                                     "cores and the reduce sums the shards " * 12}) + "\n")
    ck = os.path.join(tmp, f"ck_{nproc}_{device or 'launch'}")
    cli = ["--model", os.path.join(tmp, "model"), "--data", data, "--mode", "lora",
           "--steps", str(MULTI_CLI_STEPS), "--batch-size", str(MULTI_CLI_BATCH[0] * nproc),
           "--seq-len", str(MULTI_CLI_BATCH[1]), "--dp", str(nproc), "--ckpt-dir", ck,
           "--save-every", str(MULTI_CLI_STEPS), "--log-every", "1"]
    t0 = time.time()
    if device is None:
        proc = subprocess.run(
            [sys.executable, "-m", "generativeaiexamples_tpu_torch.tools.launch", "--nproc",
             str(nproc), "--", "generativeaiexamples_tpu_torch.tools.finetune", *cli,
             "--device", MULTI_LAUNCH_DEVICE], capture_output=True, text=True, timeout=600)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    else:
        rc, stdout, stderr = _finetune_here([*cli, "--device", device])
    wall = time.time() - t0
    lines = [l for l in stdout.splitlines() if l.strip()]
    if rc != 0 or not lines:
        raise AssertionError(f"multi (c): finetune --dp {nproc} ({device or 'launched'}) exited {rc}; "
                             f"stderr ends {stderr[-3000:]!r}")
    state = torch.load(os.path.join(ck, str(MULTI_CLI_STEPS), "state.pt"), weights_only=True)
    return {"last": json.loads(lines[-1]), "parallel": _parallel_lines(stderr),
            "adapters": state["params"], "wall_s": wall, "t0": t0}


def _multi_model(dev, tmp, seed) -> None:
    """A bf16 checkpoint of llama3-8b's width at MULTI_CLI_LAYERS layers,
    random from ``seed``, which every CLI run of (c) loads."""
    from generativeaiexamples_tpu_torch.models import hf_loader, llama

    cfg = dataclasses.replace(llama.PRESETS[MODEL], num_layers=MULTI_CLI_LAYERS)
    hf_loader.write_hf_checkpoint(cfg, os.path.join(tmp, "model"), seed=seed, dtype=torch.bfloat16,
                                  device=dev)
    gc.collect()
    torch.cuda.empty_cache()


def _same_adapters(a, b) -> float:
    """The largest difference between two checkpoints' adapters (0: bit
    for bit)."""
    return max(float((x.float() - y.float()).abs().max()) for la, lb in zip(a, b)
               for x, y in ((la[k], lb[k]) for k in la))


def _multi_procs(dev, tmp, nproc, backend, limit) -> dict:
    """(c) ``nproc`` processes through tools/launch.py against the
    in-process ``--dp nproc`` run: the checkpointed adapters within
    ``limit`` (0: bit for bit, and then the final losses too; else the
    losses within MULTI_LOSS_RTOL); the
    backend, the gradient all-reduce's time and share of the steps' wall
    and the time from the launch until every process had joined."""
    inproc = _multi_cli(tmp, nproc, str(dev))
    launched = _multi_cli(tmp, nproc, None)
    par = launched["parallel"]
    if len(par) != nproc or {p["backend"] for p in par} != {backend}:
        raise AssertionError(f"multi (c): {nproc} processes reported {par}")
    diff = _same_adapters(launched["adapters"], inproc["adapters"])
    loss, want = launched["last"]["final_loss"], inproc["last"]["final_loss"]
    same_loss = loss == want if limit == 0 else abs(loss - want) <= MULTI_LOSS_RTOL * abs(want)
    if not (diff <= limit and same_loss):
        raise AssertionError(f"multi (c): {nproc} processes' adapters part from the in-process run's "
                             f"by {diff!r} (limit {limit}); final loss {loss!r} against {want!r}")
    steps_s = max(p["steps_s"] for p in par)
    reduce_s = max(p["all_reduce_s"] for p in par)
    joined = max(p["joined_at"] for p in par) - launched["t0"]
    grad = max(par[0]["all_reduces"], key=lambda c: c[0])  # (bytes, seconds): the gradients'
    grad_ms = 1e3 * statistics.median(s for b, s in par[0]["all_reduces"] if b == grad[0])
    log(f"  multi (c): finetune --mode lora --dp {nproc}, llama3-8b width at {MULTI_CLI_LAYERS} of 32 "
        f"layers (a bf16 checkpoint), {MULTI_CLI_BATCH[0]} x {MULTI_CLI_BATCH[1]} a replica, "
        f"{MULTI_CLI_STEPS} steps: {nproc} processes through tools/launch.py on "
        f"{[p['device'] for p in par]}, backend {backend}, against the in-process --dp {nproc} run "
        f"on {dev}: adapters max |diff| {diff!r} (limit {limit}), final loss {loss:.6f} / "
        f"{want:.6f}; every process joined the group {joined:.2f} s after the launch; the gradient "
        f"all-reduce ({grad[0] / 2**20:.2f} MiB f32) {grad_ms:.2f} ms a step (median); all "
        f"all-reduces {reduce_s:.3f} s of {steps_s:.2f} s of steps ({reduce_s / steps_s:.1%}); walls "
        f"launch {launched['wall_s']:.1f} s, in-process {inproc['wall_s']:.1f} s")
    return {"processes": nproc, "backend": backend, "layers": MULTI_CLI_LAYERS,
            "adapters_max_diff": diff, "final_loss": loss, "in_process_final_loss": want,
            "joined_after_launch_s": joined, "grad_all_reduce_bytes": grad[0],
            "grad_all_reduce_ms": grad_ms, "all_reduce_s": reduce_s, "steps_s": steps_s,
            "all_reduce_share": reduce_s / steps_s, "launch_wall_s": launched["wall_s"],
            "in_process_wall_s": inproc["wall_s"]}


def phase_multi(dev, smi, seed=0, scratch=None) -> dict:
    """Ring attention, sharded training, many processes (module
    docstring, phase 20)."""
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    out = {"ring": _multi_ring(dev)}
    t_a = time.time()
    out["sharded_lora"] = _multi_sharded_lora(dev, seed)
    t_b = time.time()
    tmp = tempfile.mkdtemp(prefix="multi_", dir=scratch)
    try:
        _multi_model(dev, tmp, seed)
        # two processes on the one card can only run gloo; a sum of two is
        # one rounding either way, so the adapters are held equal bit for bit
        out["processes"] = _multi_procs(dev, tmp, 2, "gloo", 0.0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"multi: the training and ring paths launched kernels {launched}")
    out["launches"] = {}
    out["wall_s"] = time.time() - t0
    out["walls_s"] = {"ring": t_a - t0, "sharded_lora": t_b - t_a, "processes": time.time() - t_b}
    log(f"  multi walls { {k: round(v, 1) for k, v in out['walls_s'].items()} }")
    if out["wall_s"] > MULTI_BUDGET_S:
        log(f"  multi: the phase took {out['wall_s']:.1f} s, over its {MULTI_BUDGET_S:.0f} s budget")
    log(f"phase multi: ok ({out['wall_s']:.1f} s on {smi})")
    return out


# ``--phases multicards``: NCCL sums four partials in a ring, in another
# order than the in-process f32 sum in replica order; AdamW's first steps
# move an element by about lr, so an element whose near-zero gradient
# changes sign may move by up to two steps (two processes: one rounding
# either way, bit for bit)
MULTICARDS_LIMITS = {2: 0.0, 4: 2 * TRAIN_LORA_LR * (1 + 2 ** -6)}


def phase_multicards(dev, smi, seed=0, scratch=None) -> dict:
    """Phase 20's legs across cards (``--phases multicards``, on 4 cards;
    not in the default run): (b) in one process on tp 2 x dp 2 over four
    cards against one device; (c) with one process a card over ``nccl``,
    2 and 4 processes through tools/launch.py against the in-process
    ``--dp`` run on the first card, within MULTICARDS_LIMITS; the
    gradient all-reduce's time and share of the steps' wall."""
    need = max(MULTICARDS_PROCS)
    if torch.cuda.device_count() < need:
        raise RuntimeError(f"multicards: {need} cards wanted, {torch.cuda.device_count()} visible")
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"sharded_lora": _multi_sharded_lora(
        dev, seed, MULTICARDS_MESH, [torch.device("cuda", i) for i in range(need)])}
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="multicards_", dir=scratch)
    try:
        _multi_model(dev, tmp, seed)
        for n in MULTICARDS_PROCS:
            out[f"processes_{n}"] = _multi_procs(dev, tmp, n, "nccl", MULTICARDS_LIMITS[n])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {}
    out["wall_s"] = time.time() - t0
    log(f"phase multicards: ok ({out['wall_s']:.1f} s on {need} x {smi})")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases",
                        default="kernels,model,serve,retrieval,rag,chains,filechains,apps,"
                                "agents,drain,prefix,spec,observe,route,connect,tp,train,tpx,pp,"
                                "multi",
                        help="phases after the build, comma-separated (default: all but "
                             "ppcards and multicards, which want 4 cards)")
    parser.add_argument("--checks", default=",".join(CHECKS),
                        help="phase 3's kernel checks, comma-separated (default: all)")
    parser.add_argument("--recipes", default="ABCD", help="phase 5's engines (default: ABCD)")
    parser.add_argument("--runahead", type=int, default=None,
                        help="decode_runahead of phase 5's engines (default: the config's)")
    parser.add_argument("--timing-only", action="store_true",
                        help="leave out phase 5's runahead and overload checks")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase 6's weights and passages (default: 0)")
    parser.add_argument("--tpx-profile-shards", default=None,
                        help="run only phase 18 (e)'s profile on each of these shard counts "
                             "(comma-separated) and print the readings as JSON (phase 18 "
                             "starts it as a process of its own)")
    parser.add_argument("--observe-child", action="store_true",
                        help="run only phase 13 and print its readings as JSON (the default "
                             "run starts it as a process of its own)")
    parser.add_argument("--connect-child", action="store_true",
                        help="run only phase 15 and print its readings as JSON (the default "
                             "run starts it as a process of its own)")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if args.tpx_profile_shards is not None:
        result = tpx_profile_child(torch.device("cuda", 0), args.seed,
                                   [int(n) for n in args.tpx_profile_shards.split(",")])
        print(json.dumps(result), flush=True)
        return 0
    if args.observe_child or args.connect_child:
        run = phase_observe if args.observe_child else phase_connect
        result = run(torch.device("cuda", 0), _smi(), args.seed)
        print(json.dumps(result), flush=True)
        return 0
    # every server the phases build arms the black box (and phase 13 profiles
    # and exports spans): their files go under a directory of this run's own
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    for key, name in (("APP_BLACKBOX_DIR", "blackbox"), ("PROFILE_LOG_DIR", "profiles"),
                      ("TRACE_JSONL_PATH", "spans.jsonl")):
        os.environ.setdefault(key, os.path.join(scratch, name))
    args.scratch = scratch
    try:
        return _run(args, phases)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run(args, phases) -> int:
    dev = torch.device("cuda", 0)
    t0 = time.time()
    info = phase_device()
    phase_build()
    results = phase_kernels(dev, args.checks.split(",")) if "kernels" in phases else {}
    if "model" in phases:
        phase_model(dev)
    serves = (phase_serve(dev, args.recipes, args.runahead, not args.timing_only)
              if "serve" in phases else {})
    later = {"rag", "chains", "filechains", "apps", "agents", "drain"}
    retrieval, encoders = (phase_retrieval(dev, info["smi"], args.seed,
                                           keep=bool(later & set(phases)))
                           if "retrieval" in phases else ({}, None))
    rag, dep = (phase_rag(dev, info["smi"], args.seed, encoders,
                          keep=bool({"chains", "filechains", "apps", "agents", "drain"}
                                    & set(phases)))
                if "rag" in phases else ({}, None))
    chains, dep = (phase_chains(dev, info["smi"], args.seed, dep, encoders,
                                keep=bool({"filechains", "apps", "agents", "drain"} & set(phases)))
                   if "chains" in phases else ({}, dep))
    # phases 10, 21, 22 and 11 run on phase 7's deployment, so before phase 9's engines
    files, dep = (phase_filechains(dev, info["smi"], args.seed, dep, encoders,
                                   keep=bool({"apps", "agents", "drain"} & set(phases)))
                  if "filechains" in phases else ({}, dep))
    apps, dep = (phase_apps(dev, info["smi"], args.seed, dep, encoders,
                            keep=bool({"agents", "drain"} & set(phases)))
                 if "apps" in phases else ({}, dep))
    agents, dep = (phase_agents(dev, info["smi"], args.seed, dep, encoders,
                                keep="drain" in phases)
                   if "agents" in phases else ({}, dep))
    drain = phase_drain(dev, info["smi"], args.seed, dep, encoders) if "drain" in phases else {}
    dep = None  # phase 11 (or 10, 21 or 22) took the deployment down
    prefix = phase_prefix(dev, info["smi"], args.seed) if "prefix" in phases else {}
    spec = phase_spec(dev, info["smi"]) if "spec" in phases else {}
    observe = (_in_child("--observe-child", "observe", args.seed, OBSERVE_CHILD_S)
               if "observe" in phases else {})
    route = phase_route(dev, info["smi"], args.seed) if "route" in phases else {}
    connect = (_in_child("--connect-child", "connect", args.seed, CONNECT_CHILD_S)
               if "connect" in phases else {})
    tp = phase_tp(dev, info["smi"], args.seed) if "tp" in phases else {}
    train = phase_train(dev, info["smi"], args.seed, args.scratch) if "train" in phases else {}
    tpx = phase_tpx(dev, info["smi"], args.seed) if "tpx" in phases else {}
    pp = phase_pp(dev, info["smi"], args.seed, args.scratch) if "pp" in phases else {}
    ppcards = phase_ppcards(dev, info["smi"], args.seed) if "ppcards" in phases else {}
    multi = phase_multi(dev, info["smi"], args.seed, args.scratch) if "multi" in phases else {}
    multicards = (phase_multicards(dev, info["smi"], args.seed, args.scratch)
                  if "multicards" in phases else {})
    kernels = []
    tiles = results.get("tp_tiles", {})
    for name, (replaces, source) in KERNELS.items():
        if name not in results:  # a check left out by --checks
            continue
        r = dict(results[name])
        if name in tiles:  # phase 3's local tiles of phase 16's shards
            r["tp_tiles"] = tiles[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(sv["launches"][name] for sv in serves.values())
            + sum(ph.get("launches", {}).get(name, 0)
                  for ph in (rag, chains, files, apps, agents, drain, prefix, spec, observe,
                             connect, tp, train, tpx, pp, ppcards, multi, multicards)),
            "apps_launches": apps.get("launches", {}).get(name, 0),
            "agents_launches": agents.get("launches", {}).get(name, 0),
            "tp_launches": tp.get("launches", {}).get(name, 0),
            "tpx_launches": tpx.get("launches", {}).get(name, 0),
            "pp_launches": pp.get("launches", {}).get(name, 0),
            **r,
        })
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "serve": {
        name: {k: v for k, v in sv.items() if k != "launches"} for name, sv in serves.items()
    }, "retrieval": retrieval,
        "rag": {k: v for k, v in rag.items() if k != "launches"},
        "chains": {k: v for k, v in chains.items() if k != "launches"},
        "filechains": {k: v for k, v in files.items() if k != "launches"},
        "apps": {k: v for k, v in apps.items() if k != "launches"},
        "agents": {k: v for k, v in agents.items() if k != "launches"},
        "drain": {k: v for k, v in drain.items() if k != "launches"},
        "prefix": prefix.get("recipes", {}),
        "spec": {k: v for k, v in spec.items() if k != "launches"},
        "observe": {k: v for k, v in observe.items() if k != "launches"},
        "route": route,
        "connect": {k: v for k, v in connect.items() if k != "launches"},
        "tp": {k: v for k, v in tp.items() if k != "launches"},
        "train": {k: v for k, v in train.items() if k != "launches"},
        "tpx": {k: v for k, v in tpx.items() if k != "launches"},
        "pp": {k: v for k, v in pp.items() if k != "launches"},
        "ppcards": {k: v for k, v in ppcards.items() if k != "launches"},
        "multi": {k: v for k, v in multi.items() if k != "launches"},
        "multicards": {k: v for k, v in multicards.items() if k != "launches"},
        "tp_tiles": {k: v for k, v in tiles.items() if k not in results},
        "sampling": results.get("sampling")}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
