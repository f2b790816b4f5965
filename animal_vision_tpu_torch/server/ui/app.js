/* Static app logic for /ui (split out of server/app.py's former inline
   string — VERDICT round-4 next #8). DATA = {animals, categories} is
   injected by the server into index.html.

   Behavior parity with the reference React tree:
   - Picture: file -> data URL -> POST /getpic -> draw split URI
     (ui/src/Picture.tsx:87-113).
   - Video: getUserMedia environment camera, orientation-aware hidden-canvas
     JPEG capture every 200 ms (Video.tsx:23-51,129-135), WebSocket /ws when
     available else POST /getframe; species buttons; 10 s /gettip poll
     (Video.tsx:137-152).
   - Gallery (beyond the React app): POST /getgallery renders the CLI
     gallery's category grids (main.py:204-278) server-side.
   - Species-category tabs group the picker by the CLI gallery's
     NonUV / UV / Unique-UV lists (main.py:98-139). */
const ANIMALS = DATA.animals;
const CATEGORIES = DATA.categories;
let current = ANIMALS[0], running = false, ws = null, timer = null;
let currentCat = Object.keys(CATEGORIES)[0];

function show(p){
  for (const q of ['home','video','picture','gallery']){
    document.getElementById('page-'+q).classList.toggle('on', q===p);
    document.getElementById('nav-'+q).classList.toggle('on', q===p);
  }
}

const sel = document.getElementById('animal');
const row = document.getElementById('animals');
const catRow = document.getElementById('cats');
const CAT_LABELS = {nonuv: 'Non-UV', uv: 'UV', unique_uv: 'Unique UV'};

function renderAnimals(){
  row.innerHTML = '';
  for (const a of CATEGORIES[currentCat]) {
    const b = document.createElement('button'); b.textContent = a;
    if (a === current) b.classList.add('on');
    b.onclick = () => { current = a;
      for (const x of row.children) x.classList.toggle('on', x.textContent===a);
      pollTip(); };
    row.appendChild(b);
  }
}
for (const c of Object.keys(CATEGORIES)) {
  const b = document.createElement('button');
  b.textContent = CAT_LABELS[c] || c;
  if (c === currentCat) b.classList.add('on');
  b.onclick = () => { currentCat = c;
    for (const x of catRow.children) x.classList.toggle('on', x === b);
    if (!CATEGORIES[c].includes(current)) current = CATEGORIES[c][0];
    renderAnimals(); };
  catRow.appendChild(b);
}
renderAnimals();
for (const a of ANIMALS) {
  const o = document.createElement('option'); o.value=a; o.textContent=a; sel.appendChild(o);
}
const gcat = document.getElementById('gcat');
for (const c of Object.keys(CATEGORIES)) {
  const o = document.createElement('option'); o.value=c;
  o.textContent = CAT_LABELS[c] || c; gcat.appendChild(o);
}

async function go(){
  const f = document.getElementById('file').files[0];
  if(!f){ status.textContent='choose a file first'; return; }
  const reader = new FileReader();
  reader.onload = async () => {
    status.textContent = 'processing…';
    const resp = await fetch('/getpic', {method:'POST', headers:{'Content-Type':'application/json'},
      body: JSON.stringify({image: reader.result, animal: sel.value})});
    const data = await resp.json();
    if(data.image){ out.src = data.image; out.hidden = false; status.textContent=''; }
    else { status.textContent = 'error: ' + (data.error || resp.status); }
  };
  reader.readAsDataURL(f);
}

async function goGallery(){
  const f = document.getElementById('gfile').files[0];
  const gstatus = document.getElementById('gstatus');
  const gout = document.getElementById('gout');
  if(!f){ gstatus.textContent='choose a file first'; return; }
  const reader = new FileReader();
  reader.onload = async () => {
    gstatus.textContent = 'rendering ' + CATEGORIES[gcat.value].length + ' species…';
    const resp = await fetch('/getgallery', {method:'POST', headers:{'Content-Type':'application/json'},
      body: JSON.stringify({image: reader.result, category: gcat.value})});
    const data = await resp.json();
    if(data.image){ gout.src = data.image; gout.hidden = false; gstatus.textContent=''; }
    else { gstatus.textContent = 'error: ' + (data.error || resp.status); }
  };
  reader.readAsDataURL(f);
}

async function pollTip(){
  try{
    const r = await fetch('/gettip', {method:'POST', headers:{'Content-Type':'application/json'},
      body: JSON.stringify({animal: current})});
    const d = await r.json();
    document.getElementById('tip').textContent = d.tip || '';
  }catch(e){}
}
setInterval(()=>{ if(running) pollTip(); }, 10000);

if ('serviceWorker' in navigator) navigator.serviceWorker.register('/sw.js');

function grabFrame(){
  // orientation-aware capture (parity: ui/src/Video.tsx:23-51) — rotate the
  // hidden canvas by the screen orientation so the server sees upright
  // frames on rotated phones/tablets.
  const v = document.getElementById('vid'), c = document.getElementById('grab');
  if (!v.videoWidth) return null;
  const ang = (screen.orientation && screen.orientation.angle) || 0;
  const rot = ((ang % 360) + 360) % 360;
  if (rot === 90 || rot === 270) { c.width = v.videoHeight; c.height = v.videoWidth; }
  else { c.width = v.videoWidth; c.height = v.videoHeight; }
  const g = c.getContext('2d');
  g.save();
  g.translate(c.width/2, c.height/2);
  g.rotate(rot * Math.PI / 180);
  g.drawImage(v, -v.videoWidth/2, -v.videoHeight/2);
  g.restore();
  return c.toDataURL('image/jpeg', 0.8);
}
let inflight = false;
async function tick(){
  if (!running || inflight) return;
  const uri = grabFrame();
  if (!uri) return;
  inflight = true;
  if (ws && ws.readyState === 1) {
    ws.send(JSON.stringify({image: uri, animal: current}));
  } else {
    try {
      const r = await fetch('/getframe', {method:'POST', headers:{'Content-Type':'application/json'},
        body: JSON.stringify({image: uri, animal: current})});
      const d = await r.json();
      if (d.image) { vout.src = d.image; vout.hidden = false; }
    } catch(e) {}
    inflight = false;
  }
}
async function toggleCam(){
  if (running) {
    running = false;
    clearInterval(timer);
    if (ws) { ws.close(); ws = null; }
    const v = document.getElementById('vid');
    if (v.srcObject) for (const t of v.srcObject.getTracks()) t.stop();
    v.hidden = true; vout.hidden = true;
    document.getElementById('cam').textContent = 'Start camera';
    vstatus.textContent = '';
    return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia(
      {video: {facingMode: 'environment'}, audio: false});
    const v = document.getElementById('vid');
    v.srcObject = stream; v.hidden = false;
    running = true;
    document.getElementById('cam').textContent = 'Stop camera';
    try {
      ws = new WebSocket((location.protocol==='https:'?'wss://':'ws://') + location.host + '/ws');
      ws.onmessage = (ev) => { const d = JSON.parse(ev.data);
        if (d.image) { vout.src = d.image; vout.hidden = false; } inflight = false; };
      ws.onerror = () => { ws = null; };
      ws.onclose = () => { ws = null; inflight = false; };
    } catch(e) { ws = null; }
    timer = setInterval(tick, 200);
    pollTip();
  } catch(e) {
    vstatus.textContent = 'camera unavailable: ' + e;
  }
}
