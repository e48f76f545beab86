"""HTML for the playground pages (converse + kb).

Counterpart of generativeaiexamples_tpu/frontend/pages.py, copied: the
pages are byte-equal to the JAX frontend's.

Hand-rolled equivalents of the reference's Gradio pages (reference:
frontend/frontend/pages/converse.py — chat column + knowledge-base
checkbox + streaming output; pages/kb.py — upload/list/delete). The
browser talks only to this frontend's ``/api/*`` proxy, matching the
reference topology (browser → frontend → chain-server).
"""

_BASE_STYLE = """
:root { color-scheme: dark; }
* { box-sizing: border-box; margin: 0; }
body {
  font-family: system-ui, -apple-system, sans-serif;
  background: #101418; color: #e6e8ea; min-height: 100vh;
}
header {
  display: flex; align-items: center; gap: 1.5rem;
  padding: 0.8rem 1.5rem; background: #161b22; border-bottom: 1px solid #2d333b;
}
header h1 { font-size: 1.05rem; font-weight: 600; }
header nav a {
  color: #9aa4af; text-decoration: none; margin-right: 1rem; font-size: 0.9rem;
}
header nav a.active, header nav a:hover { color: #76b3fa; }
main { max-width: 900px; margin: 0 auto; padding: 1.2rem 1.5rem; }
button {
  background: #1f6feb; color: white; border: 0; border-radius: 6px;
  padding: 0.55rem 1.1rem; font-size: 0.9rem; cursor: pointer;
}
button:disabled { opacity: 0.5; cursor: default; }
button.secondary { background: #30363d; }
input[type=text], textarea {
  width: 100%; background: #0d1117; color: #e6e8ea;
  border: 1px solid #2d333b; border-radius: 6px; padding: 0.6rem;
  font-size: 0.95rem;
}
.muted { color: #9aa4af; font-size: 0.85rem; }
"""

CONVERSE_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Converse · TPU RAG Playground</title>
<style>""" + _BASE_STYLE + """
#chat { display: flex; flex-direction: column; gap: 0.7rem; padding: 1rem 0; min-height: 50vh; }
.msg { max-width: 80%; padding: 0.7rem 0.9rem; border-radius: 10px; white-space: pre-wrap; line-height: 1.45; }
.msg.user { align-self: flex-end; background: #1f6feb33; border: 1px solid #1f6feb66; }
.msg.assistant { align-self: flex-start; background: #161b22; border: 1px solid #2d333b; }
#controls { display: flex; gap: 0.6rem; align-items: center; }
#query { flex: 1; }
#kb-row { margin: 0.6rem 0; display: flex; gap: 0.5rem; align-items: center; }
</style></head>
<body>
<header>
  <h1>TPU RAG Playground</h1>
  <nav>
    <a class="active" href="/content/converse">Converse</a>
    <a href="/content/kb">Knowledge Base</a>
  </nav>
</header>
<main>
  <div id="kb-row">
    <input type="checkbox" id="use-kb">
    <label for="use-kb" class="muted">Use knowledge base</label>
  </div>
  <div id="chat"></div>
  <div id="controls">
    <input type="text" id="query" placeholder="Ask a question..." autofocus>
    <button id="mic" class="secondary" hidden title="Hold to record">🎤</button>
    <button id="send">Send</button>
  </div>
  <div id="speech-row" hidden style="margin-top:0.4rem">
    <input type="checkbox" id="speak-replies">
    <label for="speak-replies" class="muted">Speak replies</label>
  </div>
</main>
<script>
const chat = document.getElementById('chat');
const queryEl = document.getElementById('query');
const sendBtn = document.getElementById('send');
const useKb = document.getElementById('use-kb');
const micBtn = document.getElementById('mic');
const speakRow = document.getElementById('speech-row');
const speakReplies = document.getElementById('speak-replies');
const history = [];

// Speech controls appear only when the frontend has an audio backend
// configured (APP_SPEECH_SERVERURL) — same gating as the reference's
// Riva feature flags on the converse page.
fetch('/api/speech/status').then(r => r.json()).then(s => {
  if (s.asr && navigator.mediaDevices) micBtn.hidden = false;
  if (s.tts) speakRow.hidden = false;
}).catch(() => {});

let recorder = null, recChunks = [];
micBtn.addEventListener('click', async () => {
  if (recorder && recorder.state === 'recording') { recorder.stop(); return; }
  let stream;
  try {
    stream = await navigator.mediaDevices.getUserMedia({audio: true});
  } catch (err) {
    addMsg('assistant', '[mic unavailable: ' + err.message + ']');
    return;
  }
  recChunks = [];
  recorder = new MediaRecorder(stream);
  // Live partial transcripts (reference parity: Riva streaming results
  // fill the textbox as the user speaks): every timeslice, POST the
  // ACCUMULATED container stream — a valid truncated file at any
  // prefix — and show the transcript so far. One request in flight at
  // a time; partials are best-effort and the final onstop pass wins.
  let partialPending = false;
  recorder.ondataavailable = async e => {
    recChunks.push(e.data);
    if (!recorder || recorder.state !== 'recording' || partialPending) return;
    partialPending = true;
    try {
      const mime = recorder.mimeType || 'audio/webm';
      const ext = mime.includes('mp4') ? 'mp4' : mime.includes('ogg') ? 'ogg' : 'webm';
      const form = new FormData();
      form.append('file', new Blob(recChunks, {type: mime}), 'mic.' + ext);
      const resp = await fetch('/api/transcribe', {method: 'POST', body: form});
      if (resp.ok && recorder && recorder.state === 'recording') {
        const text = (await resp.json()).text;
        if (text) queryEl.value = text;
      }
    } catch (err) { /* partials are best-effort */ }
    partialPending = false;
  };
  recorder.onstop = async () => {
    stream.getTracks().forEach(t => t.stop());
    micBtn.textContent = '🎤';
    // Container format varies by browser (webm on Chrome/Firefox, mp4
    // on Safari): label the blob and filename from the recorder so the
    // audio backend picks the right decoder.
    const mime = recorder.mimeType || 'audio/webm';
    const ext = mime.includes('mp4') ? 'mp4' : mime.includes('ogg') ? 'ogg' : 'webm';
    const form = new FormData();
    form.append('file', new Blob(recChunks, {type: mime}), 'mic.' + ext);
    try {
      const resp = await fetch('/api/transcribe', {method: 'POST', body: form});
      if (!resp.ok) {
        const body = await resp.json().catch(() => ({}));
        addMsg('assistant', '[transcription failed: ' + (body.message || resp.status) + ']');
        return;
      }
      queryEl.value = (await resp.json()).text || '';
      queryEl.focus();
    } catch (err) {
      addMsg('assistant', '[transcription failed: ' + err + ']');
    }
  };
  // timeslice: ondataavailable fires every 1.5 s while recording, so
  // partial transcripts appear before the user stops talking
  recorder.start(1500);
  micBtn.textContent = '⏹';
});

async function maybeSpeak(text) {
  if (speakRow.hidden || !speakReplies.checked || !text) return;
  try {
    const resp = await fetch('/api/speak', {
      method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({text}),
    });
    if (resp.ok) {
      const url = URL.createObjectURL(await resp.blob());
      const audio = new Audio(url);
      audio.onended = () => URL.revokeObjectURL(url);
      audio.onerror = () => URL.revokeObjectURL(url);
      audio.play();
    }
  } catch (e) { /* speech is best-effort */ }
}

function addMsg(role, text) {
  const div = document.createElement('div');
  div.className = 'msg ' + role;
  div.textContent = text;
  chat.appendChild(div);
  div.scrollIntoView({behavior: 'smooth'});
  return div;
}

async function send() {
  const q = queryEl.value.trim();
  if (!q) return;
  queryEl.value = '';
  sendBtn.disabled = true;
  addMsg('user', q);
  const out = addMsg('assistant', '');
  try {
    const resp = await fetch('/api/generate', {
      method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({
        messages: [...history, {role: 'user', content: q}],
        use_knowledge_base: useKb.checked,
      }),
    });
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buffer = '';
    while (true) {
      const {done, value} = await reader.read();
      if (done) break;
      buffer += decoder.decode(value, {stream: true});
      const frames = buffer.split('\\n\\n');
      buffer = frames.pop();
      for (const frame of frames) {
        if (!frame.startsWith('data: ')) continue;
        try {
          const body = JSON.parse(frame.slice(6));
          for (const choice of body.choices || []) {
            if (choice.finish_reason === '[DONE]') continue;
            out.textContent += (choice.message || {}).content || '';
          }
        } catch (e) { /* partial frame */ }
      }
    }
    history.push({role: 'user', content: q});
    history.push({role: 'assistant', content: out.textContent});
    maybeSpeak(out.textContent);
  } catch (err) {
    out.textContent += '\\n[error: ' + err + ']';
  } finally {
    sendBtn.disabled = false;
    queryEl.focus();
  }
}
sendBtn.addEventListener('click', send);
queryEl.addEventListener('keydown', e => { if (e.key === 'Enter') send(); });
</script>
</body></html>
"""

KB_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Knowledge Base · TPU RAG Playground</title>
<style>""" + _BASE_STYLE + """
#doc-list { margin: 1rem 0; }
.doc-row {
  display: flex; justify-content: space-between; align-items: center;
  padding: 0.55rem 0.8rem; background: #161b22; border: 1px solid #2d333b;
  border-radius: 6px; margin-bottom: 0.4rem;
}
#drop {
  border: 2px dashed #2d333b; border-radius: 8px; padding: 2rem;
  text-align: center; color: #9aa4af; margin: 1rem 0;
}
#search-row { display: flex; gap: 0.6rem; margin-top: 1.5rem; }
#search-q { flex: 1; }
.hit { background: #161b22; border: 1px solid #2d333b; border-radius: 6px;
       padding: 0.7rem; margin: 0.4rem 0; font-size: 0.9rem; }
.hit .src { color: #76b3fa; font-size: 0.8rem; }
</style></head>
<body>
<header>
  <h1>TPU RAG Playground</h1>
  <nav>
    <a href="/content/converse">Converse</a>
    <a class="active" href="/content/kb">Knowledge Base</a>
  </nav>
</header>
<main>
  <div id="drop">
    <p>Upload documents to the knowledge base</p><br>
    <input type="file" id="file-input" multiple>
  </div>
  <div id="status" class="muted"></div>
  <h3>Documents</h3>
  <div id="doc-list" class="muted">loading…</div>
  <div id="search-row">
    <input type="text" id="search-q" placeholder="Search the knowledge base...">
    <button id="search-btn" class="secondary">Search</button>
  </div>
  <div id="hits"></div>
</main>
<script>
const docList = document.getElementById('doc-list');
const statusEl = document.getElementById('status');

async function refresh() {
  try {
    const resp = await fetch('/api/documents');
    const body = await resp.json();
    const docs = body.documents || [];
    docList.innerHTML = '';
    if (!docs.length) { docList.textContent = 'no documents ingested yet'; return; }
    for (const doc of docs) {
      const row = document.createElement('div');
      row.className = 'doc-row';
      const name = document.createElement('span');
      name.textContent = doc;
      const del = document.createElement('button');
      del.className = 'secondary';
      del.textContent = 'Delete';
      del.onclick = async () => {
        await fetch('/api/documents?filename=' + encodeURIComponent(doc), {method: 'DELETE'});
        refresh();
      };
      row.append(name, del);
      docList.appendChild(row);
    }
  } catch (err) { docList.textContent = 'error: ' + err; }
}

document.getElementById('file-input').addEventListener('change', async (e) => {
  for (const file of e.target.files) {
    statusEl.textContent = 'uploading ' + file.name + '…';
    const form = new FormData();
    form.append('file', file);
    const resp = await fetch('/api/documents', {method: 'POST', body: form});
    statusEl.textContent = resp.ok ? 'uploaded ' + file.name : 'failed: ' + file.name;
  }
  refresh();
});

document.getElementById('search-btn').addEventListener('click', async () => {
  const q = document.getElementById('search-q').value.trim();
  if (!q) return;
  const resp = await fetch('/api/search', {
    method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({query: q, top_k: 4}),
  });
  const body = await resp.json();
  const hits = document.getElementById('hits');
  hits.innerHTML = '';
  for (const chunk of body.chunks || []) {
    const div = document.createElement('div');
    div.className = 'hit';
    const src = document.createElement('div');
    src.className = 'src';
    src.textContent = chunk.filename + '  ·  score ' + (chunk.score || 0).toFixed(3);
    const txt = document.createElement('div');
    txt.textContent = chunk.content;
    div.append(src, txt);
    hits.appendChild(div);
  }
});
refresh();
</script>
</body></html>
"""
