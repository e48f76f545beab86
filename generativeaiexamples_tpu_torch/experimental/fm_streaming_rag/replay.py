"""File-replay transcript source.

Counterpart of the JAX repository's experimental/fm_streaming_rag/
replay.py: it stands in for a radio front end by reading any text file and
streaming it to ``/storeStreamingText`` in word-sized bites at a set pace
(``replay``), or by streaming a WAV file through streaming ASR
(``replay_audio``, the port's ``frontend.speech.ASRClient``) and posting
each partial transcript's new text. Its posts go through ``urllib``.

    python -m generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.replay \\
        --file transcript.txt --server http://127.0.0.1:8071

It is an HTTP client and runs no model.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Iterator


def chunk_words(text: str, words_per_chunk: int) -> Iterator[str]:
    words = text.split()
    for i in range(0, len(words), words_per_chunk):
        yield " ".join(words[i: i + words_per_chunk])


def replay(
    path: str,
    server_url: str,
    source_id: str = "file-replay",
    words_per_chunk: int = 12,
    interval: float = 0.5,
    flush: bool = True,
) -> int:
    """POST the file's text to the streaming server; returns chunks sent."""
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    sent = 0
    for piece in chunk_words(text, words_per_chunk):
        _post_transcript(server_url, source_id, piece)
        sent += 1
        if interval:
            time.sleep(interval)
    if flush:
        _flush(server_url, source_id)
    return sent


def _post(server_url: str, path: str, doc: dict) -> None:
    req = urllib.request.Request(
        f"{server_url.rstrip('/')}{path}",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        resp.read()


def _post_transcript(server_url: str, source_id: str, piece: str) -> None:
    _post(server_url, "/storeStreamingText", {"source_id": source_id, "transcript": piece})


def _flush(server_url: str, source_id: str) -> None:
    _post(server_url, "/flushStream", {"source_id": source_id})


def iter_wav_chunks(path: str, chunk_seconds: float = 2.0) -> Iterator[bytes]:
    """Slice a WAV file into playable time-aligned byte chunks: a RIFF
    header and the first window's frames first, then raw frame spans;
    every accumulated prefix stays a decodable (truncated) WAV, which lets
    the one-shot ASR contract serve streaming recognition
    (frontend/speech.py ``streaming_recognize``).

    The header declares the whole file's frames, so a decoder reads every
    frame a prefix holds. (JAX's copy writes the header through ``wave``,
    which declares the first window's frames only, so each of its prefixes
    decodes to the first window; the two headers have the same length.)"""
    import struct
    import wave

    with wave.open(path, "rb") as wf:
        frames_per_chunk = max(1, int(wf.getframerate() * chunk_seconds))
        channels, width, rate = wf.getnchannels(), wf.getsampwidth(), wf.getframerate()
        total = wf.getnframes()
        data_bytes = total * channels * width
        # the canonical 44-byte PCM header ``wave`` writes, for all ``total`` frames
        header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + data_bytes, b"WAVE", b"fmt ",
                             16, 1, channels, rate, rate * channels * width, channels * width,
                             width * 8, b"data", data_bytes)
        read = 0
        while read < total:
            frames = wf.readframes(frames_per_chunk)
            yield header + frames if read == 0 else frames
            read += frames_per_chunk


def replay_audio(
    path: str,
    server_url: str,
    asr,
    source_id: str = "wav-replay",
    chunk_seconds: float = 2.0,
    interval: float = 0.0,
    flush: bool = True,
) -> int:
    """Replay a WAV through streaming ASR into the streaming server:
    audio chunks stream through ``asr.streaming_recognize`` (partial
    transcripts, each covering the stream so far), the new text of each
    partial posts to ``/storeStreamingText``, and the accumulator and
    timestamp database take it from there. Returns the deltas sent.
    """
    sent = 0
    prev = ""
    for partial in asr.streaming_recognize(iter_wav_chunks(path, chunk_seconds)):
        # growing partials: ship only the new suffix; a revised partial
        # (ASR re-hearing earlier audio) ships in full
        delta = partial[len(prev):] if partial.startswith(prev) else partial
        prev = partial
        if delta.strip():
            _post_transcript(server_url, source_id, delta.strip())
            sent += 1
        if interval:
            time.sleep(interval)
    if flush:
        _flush(server_url, source_id)
    return sent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Replay a text file as a live stream")
    parser.add_argument("--file", required=True)
    parser.add_argument("--server", default="http://127.0.0.1:8071")
    parser.add_argument("--source-id", default="file-replay")
    parser.add_argument("--words-per-chunk", type=int, default=12)
    parser.add_argument("--interval", type=float, default=0.5)
    parser.add_argument(
        "--wav", action="store_true",
        help="treat --file as a WAV and stream it through ASR "
             "(APP_SPEECH_SERVERURL must point at an audio service)",
    )
    args = parser.parse_args(argv)
    if args.wav:
        from generativeaiexamples_tpu_torch.frontend.speech import ASRClient

        sent = replay_audio(
            args.file, args.server, ASRClient(), args.source_id,
            interval=args.interval,
        )
    else:
        sent = replay(
            args.file, args.server, args.source_id, args.words_per_chunk,
            args.interval,
        )
    print(f"replayed {sent} chunks", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
