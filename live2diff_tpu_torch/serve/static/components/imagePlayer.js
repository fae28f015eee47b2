// Output pane: MJPEG stream display + PNG snapshot download — counterpart
// of the reference frontend's ImagePlayer.svelte (takeSnapshot) and the
// snapImage helper in utils.ts
// (the original Live2Diff demo's frontend/src/lib/components/ImagePlayer.svelte).

import { values } from '../lib/store.js';

let imgEl = null, snapEl = null;

export function bind(img, snapBtn) {
  imgEl = img; snapEl = snapBtn;
  snapEl.onclick = takeSnapshot;
}

export function play(userId) {
  imgEl.src = `/api/stream/${userId}`;
  snapEl.hidden = false;
}

export function stopPlayer() {
  imgEl.src = '';
  snapEl.hidden = true;
}

// Filename carries the prompt + seed + timestamp, like utils.ts snapImage.
export function takeSnapshot() {
  if (!imgEl.src || !imgEl.naturalWidth) return;
  const c = document.createElement('canvas');
  c.width = imgEl.naturalWidth; c.height = imgEl.naturalHeight;
  c.getContext('2d').drawImage(imgEl, 0, 0);
  const a = document.createElement('a');
  const stamp = new Date().toISOString().replace(/[:.]/g, '-');
  const prompt = String(values.prompt || 'frame').slice(0, 60)
    .replace(/[^\w\- ]+/g, '').trim().replace(/\s+/g, '_');
  a.download = `live2diff_${prompt}_seed${values.seed ?? ''}_${stamp}.png`;
  a.href = c.toDataURL('image/png');
  a.click();
}
