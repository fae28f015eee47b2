// Input pane: camera / screen-share buttons and the camera device switcher
// — counterpart of the reference frontend's VideoInput.svelte +
// MediaListSwitcher.svelte
// (the original Live2Diff demo's frontend/src/lib/components/VideoInput.svelte).

import * as media from '../lib/mediaStream.js';

export function bind({ video, cameraBtn, screenBtn, cameraList, toggle, warn }) {
  media.bind(video, () => { toggle.disabled = false; });
  cameraBtn.onclick = () => media.startCamera(undefined, cameraList, warn);
  screenBtn.onclick = () => media.startScreenCapture(warn);
  cameraList.onchange = e => media.startCamera(e.target.value, cameraList, warn);
}
