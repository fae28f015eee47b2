// Dynamic settings form rendered from the /api/settings JSON-schema —
// counterpart of the reference frontend's PipelineOptions.svelte and its
// per-field components (TextArea / InputRange / SeedInput / Checkbox /
// Selectlist, the original Live2Diff demo's frontend/src/lib/components/). Fields
// marked `hide` land in the collapsible advanced form; `disabled` fields
// keep their default but render nothing.

import { values } from '../lib/store.js';

export function renderOptions(settings, featuredForm, advancedForm, advancedDetails) {
  const props = settings.input_params.properties;
  const featured = [], advanced = [];
  for (const [id, p] of Object.entries(props)) {
    if (p.disabled) { values[id] = p.default; continue; }
    (p.hide ? advanced : featured).push([id, p]);
    values[id] = p.default;
  }
  renderFields(featuredForm, featured);
  if (advanced.length) {
    advancedDetails.hidden = false;
    renderFields(advancedForm, advanced);
  }
}

function renderFields(form, fields) {
  for (const [id, p] of fields) {
    const wrap = document.createElement('div');
    const label = document.createElement('label');
    label.textContent = p.title || id;
    label.htmlFor = `f-${id}`;
    wrap.appendChild(label);
    let input;
    const field = p.field || (p.type === 'boolean' ? 'checkbox' : 'text');
    if (field === 'textarea') {
      input = document.createElement('textarea');
      input.value = p.default ?? '';
      input.oninput = () => values[id] = input.value;
    } else if (field === 'range') {
      const row = document.createElement('div');
      row.className = 'range-row';
      input = document.createElement('input');
      input.type = 'range';
      input.min = p.min ?? 0; input.max = p.max ?? 1; input.step = p.step ?? 0.01;
      input.value = p.default ?? 0;
      const out = document.createElement('output');
      out.value = input.value;
      input.oninput = () => { values[id] = Number(input.value); out.value = input.value; };
      row.appendChild(input); row.appendChild(out);
      wrap.appendChild(row); form.appendChild(wrap);
      input.id = `f-${id}`;
      continue;
    } else if (field === 'checkbox') {
      input = document.createElement('input');
      input.type = 'checkbox';
      input.checked = !!p.default;
      input.onchange = () => values[id] = input.checked;
    } else if (field === 'select') {
      input = document.createElement('select');
      for (const v of p.values || []) {
        const o = document.createElement('option');
        o.value = o.textContent = v;
        input.appendChild(o);
      }
      input.value = p.default ?? '';
      input.onchange = () => values[id] = input.value;
    } else if (field === 'seed' || p.type === 'integer' || p.type === 'number') {
      const row = document.createElement('div');
      row.className = 'range-row';
      input = document.createElement('input');
      input.type = 'number';
      input.value = p.default ?? 0;
      input.oninput = () => values[id] = Number(input.value);
      row.appendChild(input);
      if (field === 'seed') {
        const btn = document.createElement('button');
        btn.type = 'button'; btn.textContent = '🎲'; btn.className = 'secondary';
        btn.onclick = () => { input.value = Math.floor(Math.random() * 1e7);
                              values[id] = Number(input.value); };
        row.appendChild(btn);
      }
      wrap.appendChild(row); form.appendChild(wrap);
      input.id = `f-${id}`;
      continue;
    } else {
      input = document.createElement('input');
      input.type = 'text';
      input.value = p.default ?? '';
      input.oninput = () => values[id] = input.value;
    }
    input.id = `f-${id}`;
    wrap.appendChild(input);
    form.appendChild(wrap);
  }
}
