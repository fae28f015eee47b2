// WebSocket streaming state machine — counterpart of the reference
// frontend's lcmLive.ts (the original Live2Diff demo's frontend/src/lib/lcmLive.ts):
// connect with a fresh userId, answer each server "send_frame" with
// {next_frame} + the current parameter values + a JPEG frame, and surface
// connected / wait / timeout / error transitions through the status store.

import { Status, setStatus, values } from './store.js';
import { grabFrame } from './mediaStream.js';

let websocket = null;
let frameCount = 0, fpsT0 = 0;
let fpsEl = null;

export function bindFps(el) { fpsEl = el; }

export function start({ onConnected, warn }) {
  return new Promise((resolve, reject) => {
    const userId = crypto.randomUUID();
    const proto = location.protocol === 'https:' ? 'wss' : 'ws';
    websocket = new WebSocket(`${proto}://${location.host}/api/ws/${userId}`);
    websocket.onclose = () => setStatus(Status.DISCONNECTED);
    websocket.onerror = e => console.error(e);
    websocket.onmessage = async ev => {
      const data = JSON.parse(ev.data);
      switch (data.status) {
        case 'connected':
          setStatus(Status.CONNECTED);
          frameCount = 0; fpsT0 = performance.now();
          onConnected(userId);
          resolve(userId);
          break;
        case 'send_frame': {
          setStatus(Status.SEND_FRAME);
          websocket.send(JSON.stringify({ status: 'next_frame' }));
          websocket.send(JSON.stringify(values));
          const blob = await grabFrame();
          if (blob && websocket.readyState === WebSocket.OPEN)
            websocket.send(blob);
          frameCount += 1;
          const dt = (performance.now() - fpsT0) / 1000;
          if (dt > 1 && fpsEl) {
            fpsEl.textContent = `${(frameCount / dt).toFixed(1)} fps`;
            frameCount = 0; fpsT0 = performance.now();
          }
          break;
        }
        case 'wait': setStatus(Status.WAIT); break;
        case 'timeout':
          setStatus(Status.TIMEOUT);
          warn('Session timed out. Please try again.');
          reject(new Error('timeout'));
          break;
        case 'error':
          setStatus(Status.DISCONNECTED);
          warn(data.message || 'server error');
          reject(new Error(data.message));
          break;
      }
    };
  });
}

export function stop() {
  if (websocket) websocket.close();
  websocket = null;
  if (fpsEl) fpsEl.textContent = '';
  setStatus(Status.DISCONNECTED);
}
