"""Speech in/out via any OpenAI-compatible audio endpoint.

Counterpart of generativeaiexamples_tpu/frontend/speech.py over
``urllib`` (the JAX clients use ``requests``), with JAX's messages. Point
``APP_SPEECH_SERVERURL`` at any service exposing

- ``POST /v1/audio/transcriptions`` (multipart ``file`` + ``model``) ->
  ``{"text": ...}``  (speech-to-text), and
- ``POST /v1/audio/speech`` (JSON ``{model, input, voice, response_format}``)
  -> audio bytes  (text-to-speech),

e.g. a local whisper/piper server — and the converse page's mic/speaker
path lights up. With no URL configured both clients report unavailable
and raise :class:`SpeechUnavailable` with an actionable message, which
is what the UI surfaces.

Config env vars (read at construction):
  APP_SPEECH_SERVERURL   base URL of the audio service ("" = disabled)
  APP_SPEECH_ASRMODEL    transcription model name (default "whisper-1")
  APP_SPEECH_TTSMODEL    synthesis model name (default "tts-1")
  APP_SPEECH_VOICE       synthesis voice (default "alloy")
"""
from __future__ import annotations

import json
import os
import urllib.request
from typing import Iterable, Iterator, Optional

from generativeaiexamples_tpu_torch.utils import multipart


class SpeechUnavailable(RuntimeError):
    pass


def _server_url(explicit: str = "") -> str:
    return (explicit or os.environ.get("APP_SPEECH_SERVERURL", "")).rstrip("/")


def _post(url: str, body: bytes, content_type: str, timeout: float) -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


class ASRClient:
    """Speech-to-text over ``/v1/audio/transcriptions``."""

    def __init__(
        self,
        server_uri: str = "",
        language_code: str = "en-US",
        model: Optional[str] = None,
        timeout: float = 120.0,
    ):
        self.server_uri = _server_url(server_uri)
        self.language_code = language_code
        self.model = model or os.environ.get("APP_SPEECH_ASRMODEL", "whisper-1")
        self.timeout = timeout

    @property
    def available(self) -> bool:
        return bool(self.server_uri)

    def transcribe(self, audio: bytes, filename: str = "audio.webm") -> str:
        """One-shot transcription of an audio blob; returns the text."""
        if not self.available:
            raise SpeechUnavailable(
                "ASR requires an OpenAI-compatible audio service; set "
                "APP_SPEECH_SERVERURL (e.g. a local whisper server) or "
                "disable the mic in the UI."
            )
        body, ctype = multipart.encode(
            {"model": self.model, "language": self.language_code[:2]},
            {"file": (filename, audio)},
        )
        return json.loads(_post(f"{self.server_uri}/v1/audio/transcriptions", body, ctype,
                                self.timeout)).get("text", "")

    def streaming_recognize(self, audio_chunks: Iterable[bytes]) -> Iterator[str]:
        """Streaming recognition with partial transcripts: the one-shot
        contract is driven once per accumulated chunk window (container
        streams decode as valid truncated files at every prefix), so each
        yield is the transcript so far, converging on the final text."""
        buf = b""
        for chunk in audio_chunks:
            buf += chunk
            if buf:
                yield self.transcribe(buf)


class TTSClient:
    """Text-to-speech over ``/v1/audio/speech``."""

    def __init__(
        self,
        server_uri: str = "",
        voice: Optional[str] = None,
        model: Optional[str] = None,
        timeout: float = 120.0,
    ):
        self.server_uri = _server_url(server_uri)
        self.voice = voice or os.environ.get("APP_SPEECH_VOICE", "alloy")
        self.model = model or os.environ.get("APP_SPEECH_TTSMODEL", "tts-1")
        self.timeout = timeout

    @property
    def available(self) -> bool:
        return bool(self.server_uri)

    def synthesize(self, text: str, response_format: str = "mp3") -> bytes:
        """Synthesize ``text``; returns encoded audio bytes."""
        if not self.available:
            raise SpeechUnavailable(
                "TTS requires an OpenAI-compatible audio service; set "
                "APP_SPEECH_SERVERURL or disable the speaker in the UI."
            )
        body = json.dumps({
            "model": self.model,
            "input": text,
            "voice": self.voice,
            "response_format": response_format,
        }).encode()
        return _post(f"{self.server_uri}/v1/audio/speech", body, "application/json",
                     self.timeout)
