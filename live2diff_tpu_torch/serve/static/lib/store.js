// Shared app state — the module counterpart of the reference frontend's
// Svelte stores (the original Live2Diff demo's frontend/src/lib/store.ts): the LCM
// connection status, the live pipeline parameter values, and the parsed
// /api/settings payload. Plain module state + a tiny subscriber list
// instead of svelte/store writables.

export const Status = {
  DISCONNECTED: 'disconnected',
  CONNECTED: 'connected',
  WAIT: 'wait',
  SEND_FRAME: 'send_frame',
  TIMEOUT: 'timeout',
};

export const state = {
  lcmStatus: Status.DISCONNECTED,
  settings: null,
  maxQueueSize: 0,
};

// pipelineValues: field id -> current value (store.ts pipelineValues)
export const values = {};

const statusSubs = [];
export function onStatus(fn) { statusSubs.push(fn); }
export function setStatus(s) {
  state.lcmStatus = s;
  for (const fn of statusSubs) fn(s);
}

export async function loadSettings() {
  state.settings = await fetch('/api/settings').then(r => r.json());
  state.maxQueueSize = state.settings.max_queue_size || 0;
  return state.settings;
}
