// App bootstrap — counterpart of the reference frontend's +page.svelte
// (the original Live2Diff demo's frontend/src/routes/+page.svelte): load settings,
// render the options form, wire the start/stop toggle to the LCM WS state
// machine, and poll /api/queue while idle.

import { Status, state, onStatus, loadSettings } from './lib/store.js';
import * as lcm from './lib/lcmLive.js';
import * as media from './lib/mediaStream.js';
import { renderOptions } from './components/pipelineOptions.js';
import * as player from './components/imagePlayer.js';
import * as videoInput from './components/videoInput.js';

const els = id => document.getElementById(id);
const warn = msg => { els('warning').textContent = msg || ''; };

let queueChecker = false;

function toggleQueueChecker(start) {
  queueChecker = start && state.maxQueueSize > 0;
  if (queueChecker) pollQueue();
  if (!start) els('queue-info').textContent = '';
}

async function pollQueue() {
  if (!queueChecker) return;
  try {
    const d = await fetch('/api/queue').then(r => r.json());
    els('queue-info').textContent =
      `${d.queue_size} user(s) sharing this GPU (max ${state.maxQueueSize}).`;
  } catch {}
  setTimeout(pollQueue, 10000);
}

onStatus(s => {
  const dot = els('dot');
  dot.className = 'status-dot' +
    (s === Status.DISCONNECTED || s === Status.TIMEOUT ? '' :
     s === Status.WAIT ? ' wait' : ' connected');
  els('toggle').textContent =
    (s === Status.DISCONNECTED || s === Status.TIMEOUT) ? 'Start' : 'Stop';
  if (s === Status.DISCONNECTED) player.stopPlayer();
});

els('toggle').onclick = async () => {
  warn('');
  if (state.lcmStatus === Status.DISCONNECTED || state.lcmStatus === Status.TIMEOUT) {
    if (!media.mediaStream) { warn('Start the camera or screen share first.'); return; }
    els('toggle').disabled = true;
    try {
      await lcm.start({ onConnected: uid => player.play(uid), warn });
      toggleQueueChecker(false);
    } catch (e) { warn(e.message); toggleQueueChecker(true); }
    els('toggle').disabled = false;
  } else {
    lcm.stop();
    toggleQueueChecker(true);
  }
};

async function init() {
  const settings = await loadSettings();
  els('page-content').innerHTML = settings.page_content || '';
  renderOptions(settings, els('options'), els('advanced-options'), els('advanced'));
  lcm.bindFps(els('fps'));
  player.bind(els('out'), els('snap'));
  videoInput.bind({
    video: els('cam'), cameraBtn: els('camera-btn'), screenBtn: els('screen-btn'),
    cameraList: els('camera-list'), toggle: els('toggle'), warn,
  });
  els('loading').hidden = true;
  els('app').hidden = false;
  toggleQueueChecker(true);
}

init();
