// Camera / screen-share capture and device switching — counterpart of the
// reference frontend's mediaStream.ts
// (the original Live2Diff demo's frontend/src/lib/mediaStream.ts): getUserMedia with
// a device list for switching, getDisplayMedia for screen capture, and a
// canvas grab that center-crops the live track to the pipeline resolution.

import { values } from './store.js';

export let mediaStream = null;
let videoEl = null;
let onReady = () => {};

export function bind(video, readyCb) {
  videoEl = video;
  onReady = readyCb;
}

export async function enumerateCameras(listEl) {
  const devices = await navigator.mediaDevices.enumerateDevices();
  const cams = devices.filter(d => d.kind === 'videoinput');
  listEl.innerHTML = '';
  for (const c of cams) {
    const o = document.createElement('option');
    o.value = c.deviceId;
    o.textContent = c.label || `camera ${listEl.length + 1}`;
    listEl.appendChild(o);
  }
  listEl.hidden = cams.length < 2;
}

export async function startCamera(deviceId, listEl, warn) {
  stopMedia();
  try {
    mediaStream = await navigator.mediaDevices.getUserMedia({
      audio: false, video: { width: 1024, height: 1024, deviceId } });
    videoEl.srcObject = mediaStream;
    if (listEl) await enumerateCameras(listEl);
    onReady();
  } catch (e) { warn(`${e.name}: ${e.message}`); }
}

export async function startScreenCapture(warn) {
  stopMedia();
  try {
    mediaStream = await navigator.mediaDevices.getDisplayMedia({
      video: { displaySurface: 'window' }, audio: false,
      surfaceSwitching: 'include' });
    videoEl.srcObject = mediaStream;
    onReady();
  } catch (e) { warn(`${e.name}: ${e.message}`); }
}

export function stopMedia() {
  if (mediaStream) for (const t of mediaStream.getTracks()) t.stop();
  mediaStream = null;
  if (videoEl) videoEl.srcObject = null;
}

const canvas = document.createElement('canvas');

// Center-crop the live video to a square, scale to the pipeline size,
// return a JPEG blob (mediaStream.ts onFrameChangeStore equivalent).
export function grabFrame() {
  const [w, h] = [values.width || 512, values.height || 512];
  canvas.width = w; canvas.height = h;
  const vw = videoEl.videoWidth, vh = videoEl.videoHeight;
  if (!vw || !vh) return null;
  const s = Math.min(vw, vh);
  canvas.getContext('2d').drawImage(
    videoEl, (vw - s) / 2, (vh - s) / 2, s, s, 0, 0, w, h);
  return new Promise(res => canvas.toBlob(res, 'image/jpeg', 0.85));
}
